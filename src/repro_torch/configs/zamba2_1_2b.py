"""zamba2-1.2b — hybrid: Mamba2 backbone + ONE shared attention block.

[arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B]  38 Mamba2 blocks, d_model 2048,
ssm_state 64, head_dim 64 (d_inner 4096 => 64 mamba heads); the shared
attention+MLP block (32 heads, kv 32, d_ff 8192) is applied with REUSED
weights every 6 mamba blocks (Zamba2's shared-block design).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    ssm_state=8,
    shared_attn_every=3,
)
