"""Dispatch wrappers: one public op per kernel, backend-selected.

Mirrors ``repro.kernels.ops`` for the ops this port has.  ``impl``:

  * ``"cuda"``  — the hand-written CUDA kernel (CUDA tensors only),
  * ``"torch"`` — the plain PyTorch version (any device),
  * ``"auto"``  — ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.

There is no fallback: ``auto`` on a CUDA tensor launches the kernel or
raises.  Model code calls these wrappers with the JAX package's layouts.

A quantized pool (int8 or ``float8_e4m3fn`` frames) comes with its
per-(frame, KV head) f32 scales ``k_scales``/``v_scales`` (N, Hkv); both
implementations dequantize with them, the kernels as they load each
element, the plain versions on the gathered view.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.kv_quant import QUANT_DTYPES

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "paged_prefill_attention", "resolve_impl", "KERNELS", "IMPLS"]

IMPLS = ("auto", "torch", "cuda")

#: every CUDA kernel on the serving path, one entry per pool dtype
#: (build, launch counts): decode, prefill, verify
KERNELS = (*_decode.KERNELS.values(), *_flash.KERNELS.values(),
           *_decode.VERIFY_KERNELS.values())


def resolve_impl(impl: str, x) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected {IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if x.is_cuda else "torch"


def _check_scales(k_pages, k_scales, v_scales) -> None:
    """An int8/fp8 pool comes with both scale tensors, (N, Hkv) f32; any
    other pool with neither."""
    quant = k_pages.dtype in QUANT_DTYPES
    if (k_scales is not None, v_scales is not None) != (quant, quant):
        raise ValueError(
            f"a {k_pages.dtype} pool takes "
            f"{'both' if quant else 'neither'} of k_scales/v_scales")
    if quant:
        want = (k_pages.shape[0], k_pages.shape[2])
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 of shape {want}, "
                                 f"got {s.dtype} {tuple(s.shape)}")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           impl: str = "auto", k_scales=None, v_scales=None):
    """q: (B, H, D); k/v_pages: (N, page, Hkv, D) pool layout;
    page_table: (B, pages_per_seq) frame ids; lengths: (B,) valid KV.
    ``k_scales``/``v_scales``: (N, Hkv) f32 for an int8/fp8 pool.
    Returns (B, H, D) in q's dtype."""
    _check_scales(k_pages, k_scales, v_scales)
    if resolve_impl(impl, q) == "torch":
        return _decode.paged_decode_attention_torch(
            q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    return _decode.paged_decode_attention_cuda(
        q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)


def paged_verify_attention(q, k_pages, v_pages, page_table, lengths, *,
                           impl: str = "auto", k_scales=None, v_scales=None):
    """Speculative verify-K attention: q (B, S, H, D) — S = K + 1 verify
    rows per sequence; k/v_pages (N, page, Hkv, D) pool layout;
    page_table (B, pages_per_seq) frame ids; lengths (B, S) valid KV per
    row.  Returns (B, S, H, D) in q's dtype.  Rows with ``lengths == 0``
    are don't-care (zeros from the kernel, a uniform average from the
    plain version).  Scales as for decode."""
    _check_scales(k_pages, k_scales, v_scales)
    if resolve_impl(impl, q) == "torch":
        return _decode.paged_verify_attention_torch(
            q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    return _decode.paged_verify_attention_cuda(
        q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)


def paged_prefill_attention(q, k_pages, v_pages, page_rows, offset, lengths,
                            *, window: int = 0, impl: str = "auto",
                            k_scales=None, v_scales=None):
    """Prompt-chunk attention over the paged KV pool (chunked prefill).

    q: (C, T, H, D) — one prompt chunk per row, model layout;
    k/v_pages: (N, page, Hkv, D) pool layout; page_rows: (C, pages_per_seq)
    frame ids; offset/lengths: (C,) absolute start + valid tokens per row.
    Rows at or past ``lengths`` are don't-care.  Scales as for decode.
    Returns q's shape and dtype."""
    _check_scales(k_pages, k_scales, v_scales)
    fn = (_flash.paged_prefill_attention_torch
          if resolve_impl(impl, q) == "torch"
          else _flash.paged_prefill_attention_cuda)
    return fn(q, k_pages, v_pages, page_rows, offset, lengths, window=window,
              k_scales=k_scales, v_scales=v_scales)
