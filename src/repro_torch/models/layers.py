"""Primitive layers on tensors, the counterparts of ``repro.models.layers``.

Conventions (as in the JAX package):
  * params are nested dicts of tensors; apply fns take (params, x, ...),
  * params are stored in ``param_dtype`` (f32) and used in
    ``compute_dtype`` (bf16).  ``dense``/``embed``/``unembed`` cast with
    ``Tensor.to``, which returns the tensor itself when it already has
    that dtype — the engine casts the weights once at load time, so no
    step pays the cast (the numbers are the same: the cast is
    deterministic),
  * the norms use the JAX package's baseline numerics (f32 statistics
    and f32 elementwise math, rounded back to the input dtype).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["dense", "rms_norm", "embed", "unembed", "rope", "mrope",
           "rope_freqs", "swiglu"]

Params = Dict[str, torch.Tensor]


def dense(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed(p: Params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["table"].to(compute_dtype)[tokens.long()]


def unembed(p: Params, x: torch.Tensor, *, logit_scale: float = 1.0,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Project to vocab logits.  ``p`` is the embed table or lm_head."""
    logits = x.to(compute_dtype) @ p["table"].to(compute_dtype).T
    if logit_scale != 1.0:
        logits = logits * logit_scale
    return logits


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _apply_rot(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two *halves* (x[..., :d/2], x[..., d/2:]) — the GPT-NeoX
    convention the JAX package's code uses (its docstring says pairs)."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Standard RoPE.  x: (..., S, H, D); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    return _apply_rot(x.float(), cos, sin).to(x.dtype)


def mrope(x: torch.Tensor, positions: torch.Tensor, sections: Sequence[int],
          theta: float = 10_000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head_dim / 2 frequencies split
    into (t, h, w) sections, each driven by its own row of positions.

    x: (B, S, H, D); positions: (3, B, S) int (t / h / w ids, equal for
    text, where the result is bitwise :func:`rope`'s)."""
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"{d_half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    sec_ids = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(list(sections), device=x.device))        # (D/2,)
    pos = positions.float()[sec_ids].movedim(0, -1)           # (B, S, D/2)
    angles = pos * freqs
    cos = torch.cos(angles)[..., None, :]                     # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    return _apply_rot(x.float(), cos, sin).to(x.dtype)


def swiglu(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    g = dense(p["gate"], x, compute_dtype)
    u = dense(p["up"], x, compute_dtype)
    return dense(p["down"], torch.nn.functional.silu(g) * u, compute_dtype)
