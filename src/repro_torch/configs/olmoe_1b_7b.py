"""olmoe-1b-7b — fully open MoE: 64 experts, top-8, every layer.

[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B]  16L, d_model 2048, 16 heads
(kv 16 => MHA), expert d_ff 1024, vocab 50304, 64 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    moe_every=1,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    moe_every=1,
)
