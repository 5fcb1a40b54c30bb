"""qwen2-vl-72b — VLM backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B]  80L, d_model 8192, 64 heads
(GQA kv 8, head_dim 128), d_ff 29568, vocab 152064,
mrope_section (16, 24, 24).  The vision tower is a stub: early-fused
token/patch streams arrive as token ids plus (t, h, w) position ids of
shape (3, B, S).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    mrope_sections=(4, 2, 2),
    frontend="vision_stub",
)
