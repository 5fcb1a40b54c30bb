"""mistral-nemo-12b — dense 128k-context LM.

[hf:mistralai/Mistral-Nemo-Base-2407]  40L, d_model 5120, 32 heads
(GQA kv 8), head_dim 128 (explicit — not d_model/heads), d_ff 14336,
vocab 131072, rope_theta 1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="nemo-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,           # head_dim != d_model/heads, like the real config
    d_ff=256,
    vocab_size=512,
)
