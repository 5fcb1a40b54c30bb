"""rwkv6-7b — RWKV-6 "Finch" 7B: attention-free, data-dependent decay.

[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]  32L, d_model 4096,
head_size 64 (=> 64 heads), channel-mix ratio 3.5 (d_ff 14336),
vocab 65536 (RWKV World tokenizer).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # head_size 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=448,
    vocab_size=512,
    attention="none",
)
