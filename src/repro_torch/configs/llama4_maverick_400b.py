"""llama4-maverick-400b-a17b — MoE with early fusion, 128 experts top-1.

[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified tier]  48L,
d_model 5120, 40 heads (GQA kv 8, head_dim 128), expert d_ff 8192,
vocab 202048, 128 experts top-1 + shared expert.

DEVIATION (the JAX package's, kept in this copy): MoE on alternate
layers (``moe_every=2``), matching the released model's interleaved
MoE/dense pattern and the "400B total / 17B active" name; a flat
48Lx128e reading would give ~780B total, contradicting the name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,
    shared_expert=True,
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=512,
    num_experts=8,
    experts_per_token=1,
    moe_every=2,
    shared_expert=True,
)
