"""command-r-plus-104b — large dense LM, GQA, no biases, tied embeddings.

[hf:CohereForAI/c4ai-command-r-plus; unverified tier]  64L, d_model 12288,
96 heads (GQA kv 8, head_dim 128), d_ff 33792, vocab 256000, qk-norm,
tied embeddings with logit_scale (Cohere convention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    logit_scale=0.0625,
)

SMOKE = ModelConfig(
    name="commandr-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    qk_norm=True,
    tie_embeddings=True,
    logit_scale=0.0625,
)
