"""phi4-mini-3.8b — dense LM: RoPE + SwiGLU + GQA.

[arXiv:2412.08905; hf:microsoft/Phi-4-mini]  32L, d_model 3072, 24 heads
(GQA kv 8, head_dim 128), d_ff 8192, vocab 200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
)

SMOKE = ModelConfig(
    name="phi4-smoke",
    family="dense",
    num_layers=3,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
)
