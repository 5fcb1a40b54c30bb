"""Config dataclasses, copies of the JAX package's: the model
architecture (:class:`ModelConfig`), an input shape (:class:`ShapeConfig`,
the shape suite :data:`SHAPES`) and the training loop's knobs
(:class:`TrainConfig`).

Every architecture in ``repro_torch/configs/<id>.py`` instantiates
:class:`ModelConfig` with the exact published dimensions (``CONFIG``) plus
a reduced same-family ``SMOKE`` config for CPU tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (family + dimensions + feature flags)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # -- attention flavour --------------------------------------------------
    attention: str = "full"          # full | swa | none
    window: int = 0                  # SWA window (h2o-danube)
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w)
    qk_norm: bool = False            # command-r-plus style
    logit_scale: float = 1.0
    tie_embeddings: bool = False

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # MoE on layers where (i % moe_every)==moe_every-1
    shared_expert: bool = False      # llama4-style shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- SSM / RWKV ----------------------------------------------------------
    ssm_state: int = 0               # N (mamba2) / head K dim (rwkv6 uses head_dim)
    ssm_conv: int = 4                # depthwise causal conv width
    ssm_expand: int = 2              # d_inner = expand * d_model
    shared_attn_every: int = 0       # zamba2: shared attn block cadence

    # -- encoder-decoder -----------------------------------------------------
    encoder_layers: int = 0          # seamless-m4t
    frontend: str = "none"           # none | audio_stub | vision_stub

    # -- numerics ------------------------------------------------------------
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.num_heads))
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads must divide by num_kv_heads")

    # -- derived -------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 so it shards on any mesh axis we use."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    @property
    def is_subquadratic(self) -> bool:
        """May run long_500k: SSM/linear/hybrid/SWA families."""
        return self.family in ("ssm", "hybrid") or self.attention == "swa"

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs decode (enc-dec has a decoder)

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, V = self.d_model, self.padded_vocab
        total = V * d                       # input embedding
        if not self.tie_embeddings:
            total += V * d                  # lm head
        total += self.num_layers * self._block_params()
        if self.family == "encdec":
            total += self.encoder_layers * self._encoder_block_params()
        if self.shared_attn_every:
            total += self._shared_attn_params()
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (d * self.num_heads * hd          # q
                + 2 * d * self.num_kv_heads * hd  # k, v
                + self.num_heads * hd * d)        # o

    def _ffn_params(self, d_ff: Optional[int] = None) -> int:
        ff = d_ff or self.d_ff
        return 3 * self.d_model * ff             # swiglu gate/up/down

    def _block_params(self) -> int:
        d = self.d_model
        if self.family == "ssm" and self.name.startswith("rwkv"):
            # time-mix (r,k,v,g,o ~ 5 d^2 + decay lora) + channel-mix
            return 5 * d * d + 2 * d * self.d_ff + 2 * d
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            n = self.ssm_state
            blk = d * (2 * di + 2 * n * (di // max(1, self.head_dim)) if False else 0)
            # mamba2: in_proj d->(2*di + 2*n_groups*N + heads), out_proj di->d
            heads = di // self.head_dim
            blk = d * (2 * di + 2 * n + heads) + di * d + self.ssm_conv * (di + 2 * n)
            return blk + 2 * d
        moe_layer = (self.num_experts > 0)
        ffn = self._ffn_params()
        if moe_layer:
            n_moe = self.num_layers // self.moe_every
            n_dense = self.num_layers - n_moe
            per_moe = self.num_experts * ffn + (ffn if self.shared_expert else 0) \
                + self.d_model * self.num_experts
            avg = (n_moe * per_moe + n_dense * ffn) / self.num_layers
            return int(self._attn_params() + avg + 2 * self.d_model)
        return self._attn_params() + ffn + 2 * self.d_model

    def _encoder_block_params(self) -> int:
        return self._attn_params() + self._ffn_params() + 2 * self.d_model

    def _shared_attn_params(self) -> int:
        return self._attn_params() + self._ffn_params() + 2 * self.d_model

    def active_param_count(self) -> int:
        """Per-token active params (MoE: routed top-k only) for 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        ffn = self._ffn_params()
        n_moe = self.num_layers // self.moe_every
        n_dense = self.num_layers - n_moe
        active_blocks = self.num_layers * (self._attn_params() + 2 * d) \
            + n_dense * ffn \
            + n_moe * (self.experts_per_token * ffn
                       + (ffn if self.shared_expert else 0)
                       + d * self.num_experts)
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return emb + active_blocks


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape suite cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs.  On one device ``zero1`` and ``act_sharding``
    have nothing to shard; they are kept so the fields stay the
    reference's."""

    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1            # gradient accumulation
    remat: str = "block"             # none | block | dots
    zero1: bool = True               # shard optimizer state over data axis
    grad_compression: str = "none"   # none | bf16
    seed: int = 0
    checkpoint_every: int = 100
    log_every: int = 10
    act_sharding: str = "baseline"   # baseline | optimized
