"""seamless-m4t-medium — encoder-decoder multimodal translation backbone.

[arXiv:2308.11596; hf:facebook/seamless-m4t-medium]  12L enc + 12L dec,
d_model 1024, 16 heads (kv 16 => MHA), d_ff 4096, vocab 256206.
The speech/text frontend is a stub, as in the JAX package: precomputed
frame embeddings (B, S, d) go straight into the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    frontend="audio_stub",
)
