"""Quantized paged KV frames: int8 / fp8 pool storage, on tensors.

The port's copy of the JAX package's ``kernels/kv_quant.py``.  The page
pool's frame dtype is a knob (:class:`KVQuantConfig`, ``none | int8 |
fp8``).  Quantized frames carry **per-(frame, KV-head) symmetric absmax
scales**, one f32 per pool frame per KV head per layer, as ``k_scales``
/ ``v_scales`` of shape ``(L, n_frames, Hkv)`` beside the pool.  The
scales ride every page transfer as two more keys of the page payload.

Scale discipline (monotone absmax with row-0 reset), as in the JAX
package:

* writing **row 0** of a frame starts a fresh page: the scale is
  overwritten with the token's absmax and the frame's old content is
  zeroed (``ratio = 0``);
* writing a later row only ever **raises** the scale
  (``s_new = max(s_old, rowmax / qmax)``); the rows already stored are
  requantized in place, ``q' = Q(q * s_old / s_new)``;
* frames a window touches but does not write keep their bytes.

Arithmetic the bits depend on:

* the scale is ``rowmax * (1 / qmax)`` with the reciprocal rounded to
  f32 once: the JAX engine runs its steps under ``jit``, where XLA
  rewrites the division by the constant ``qmax`` into that multiply, and
  a plain division differs from it by one ulp on some inputs;
* int8 rounds half to even, then clips to ±127; fp8 clips to ±448 and
  casts to ``torch.float8_e4m3fn`` (OCP E4M3, no infinity), as the JAX
  package does.

In-place pools: the scatters write into the caller's pool and scale
tensors (the JAX package returns new arrays).  Every move of pool bytes
(gather, scatter) goes through a ``uint8`` view, so fp8 frames move as
byte copies whatever fp8 coverage torch's indexing kernels have; the
only fp8 arithmetic is the cast to and from f32.

One departure from the JAX package, byte-for-byte equal in effect:
:func:`quant_scatter_multi` requantizes only the frames a row's window
can write (the window's consecutive logical pages), where the JAX
package rewrites every frame of ``page_rows``, the untouched ones with
ratio 1, which is exact.  A full-width verify step would otherwise
rewrite 128 frames per slot and layer to change none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["KVQuantConfig", "quantize", "dequantize", "requant",
           "quant_scatter_token", "quant_scatter_multi", "QUANT_DTYPES"]

_QMAX = {"int8": 127.0, "fp8": 448.0}
_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
#: pool dtypes that carry scales
QUANT_DTYPES = tuple(_DTYPES.values())


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """Frame dtype for the paged KV pool: ``none`` (bf16, the unquantized
    engine), ``int8`` or ``fp8`` (e4m3)."""

    mode: str = "none"

    def __post_init__(self):
        if self.mode not in ("none", "int8", "fp8"):
            raise ValueError(
                f"unknown kv_quant mode {self.mode!r}; "
                f"choose one of 'none', 'int8', 'fp8'")

    @classmethod
    def from_name(cls, mode: Any) -> "KVQuantConfig":
        if mode is None:
            return cls("none")
        if isinstance(mode, KVQuantConfig):
            return mode
        return cls(str(mode))

    @classmethod
    def from_dtype(cls, dtype) -> "KVQuantConfig":
        """Recover the mode from a pool tensor's dtype."""
        for mode, dt in _DTYPES.items():
            if dtype == dt:
                return cls(mode)
        return cls("none")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def dtype(self) -> torch.dtype:
        """Pool frame dtype."""
        return _DTYPES.get(self.mode, torch.bfloat16)

    @property
    def qmax(self) -> float:
        """Largest magnitude representable at scale 1.0 (127 for int8,
        448 for fp8-e4m3, which has no infinity to overflow to)."""
        return _QMAX.get(self.mode, 0.0)

    @property
    def inv_qmax(self) -> float:
        """``1 / qmax`` rounded to f32 (exactly representable as a Python
        float, so torch's cast of it to f32 is exact)."""
        return float(np.float32(1.0) / np.float32(self.qmax))

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``uint8`` view of a 1-byte pool tensor (same shape and strides)."""
    return t.view(torch.uint8)


def quantize(x, scale, qcfg: KVQuantConfig) -> torch.Tensor:
    """Quantize f32-ish values with a broadcastable non-zero scale."""
    y = x.float() / scale
    q = qcfg.qmax
    if qcfg.mode == "int8":
        return torch.clamp(torch.round(y), -q, q).to(torch.int8)
    return torch.clamp(y, -q, q).to(torch.float8_e4m3fn)


def dequantize(q, scale) -> torch.Tensor:
    """Inverse of :func:`quantize`: f32 out, broadcastable scale."""
    return q.float() * scale


def requant(q, ratio, qcfg: KVQuantConfig) -> torch.Tensor:
    """Rescale stored values: ``q' = Q(deq(q) * ratio)`` with the new
    scale implied (ratio = s_old / s_new in [0, 1]).  Exact no-op at
    ratio 1 for both int8 and fp8."""
    return quantize(q.float() * ratio, 1.0, qcfg)


def quant_scatter_token(pages, scales, new, frame, row,
                        qcfg: KVQuantConfig) -> None:
    """Quantize-and-scatter one token per sequence (the decode site), in
    place.

    ``pages``: (n_frames, page, Hkv, D) quantized pool of one layer;
    ``scales``: (n_frames, Hkv) f32; ``new``: (B, Hkv, D);
    ``frame``/``row``: (B,) integer write targets (trash-routed).  Only
    the trash frame may repeat in ``frame``; its content is junk that no
    read sees.
    """
    frame, row = frame.long(), row.long()
    newf = new.float()
    s_tok = newf.abs().amax(dim=-1) * qcfg.inv_qmax        # (B, Hkv)
    s_old = scales[frame]                                  # (B, Hkv)
    is_start = (row == 0)[:, None]
    s_new = torch.where(is_start, s_tok, torch.maximum(s_old, s_tok))
    s_safe = torch.where(s_new > 0, s_new, 1.0)
    ratio = torch.where(is_start, 0.0, s_old / s_safe)
    raw = _raw(pages)
    old = raw[frame].view(pages.dtype)                     # (B, page, Hkv, D)
    raw[frame] = _raw(requant(old, ratio[:, None, :, None], qcfg))
    raw[frame, row] = _raw(quantize(newf, s_safe[:, :, None], qcfg))
    scales[frame] = s_new


def quant_scatter_multi(pages, scales, new, page_rows, page_idx, row, ok,
                        frame_tok, qcfg: KVQuantConfig) -> None:
    """Quantize-and-scatter a window of tokens per sequence (chunked
    prefill and verify-K sites), in place.

    ``new``: (C, T, Hkv, D); ``page_rows``: (C, P) the frames backing each
    sequence's logical pages; ``page_idx``/``row``: (C, T) logical page
    (clipped to P - 1) and in-page row per token; ``ok``: (C, T) live
    tokens; ``frame_tok``: (C, T) each token's frame, already
    trash-routed where not ``ok``.  Token t of row c sits at position
    ``start_c + t``: a row's window is consecutive positions, as at every
    call site, so it can write only the ``(T + page - 2) // page + 1``
    logical pages from ``page_idx[:, 0]`` on.  Those are the frames
    requantized; every other frame keeps its bytes and scale, which is
    what the JAX package's ratio-1 rewrite of them leaves.
    """
    C, T = page_idx.shape
    page, P = pages.shape[1], page_rows.shape[1]
    n_win = min(P, (T + page - 2) // page + 1)
    newf = new.float()
    rowmax = newf.abs().amax(dim=-1)                       # (C, T, Hkv)
    win = torch.arange(n_win, device=new.device)
    cand = torch.clamp(page_idx[:, :1].long() + win, max=P - 1)  # (C, W)
    tok_page = ((cand[:, :, None] == page_idx[:, None, :].long())
                & ok[:, None, :])                          # (C, W, T)
    chunkmax = torch.where(tok_page[..., None], rowmax[:, None],
                           0.0).amax(dim=2)                # (C, W, Hkv)
    has_start = (tok_page & (row == 0)[:, None, :]).any(dim=2)   # (C, W)
    frames = torch.gather(page_rows.long(), 1, cand)       # (C, W)
    s_old = scales[frames]                                 # (C, W, Hkv)
    base = torch.where(has_start[..., None], 0.0, s_old)
    s_new = torch.maximum(base, chunkmax * qcfg.inv_qmax)
    s_safe = torch.where(s_new > 0, s_new, 1.0)
    ratio = torch.where(has_start[..., None], 0.0, s_old / s_safe)
    raw = _raw(pages)
    old = raw[frames].view(pages.dtype)          # (C, W, page, Hkv, D)
    raw[frames] = _raw(requant(old, ratio[:, :, None, :, None], qcfg))
    # each token's scale: its page's slot in the window (clamped for the
    # tokens that are not ok, whose writes land on the trash frame)
    slot = torch.clamp(page_idx.long() - cand[:, :1], 0, n_win - 1)
    st = torch.gather(s_safe, 1,
                      slot[..., None].expand(-1, -1, s_safe.shape[-1]))
    raw[frame_tok.long(), row.long()] = _raw(quantize(newf, st[..., None],
                                                      qcfg))
    scales[frames] = s_new
