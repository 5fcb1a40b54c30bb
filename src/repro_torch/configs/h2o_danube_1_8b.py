"""h2o-danube-1.8b — llama/mistral-style dense LM with sliding-window attn.

[arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base]  24L, d_model 2560,
32 heads (GQA kv 8, head_dim 80), d_ff 6912, vocab 32000, SWA window 4096.
SWA makes it sub-quadratic, so the long_500k shape RUNS for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    attention="swa",
    window=4096,
)

SMOKE = ModelConfig(
    name="danube-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    attention="swa",
    window=8,
)
