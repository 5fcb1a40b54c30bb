"""Dispatch wrappers: one public op per kernel, backend-selected.

Mirrors ``repro.kernels.ops`` for the ops this port has.  ``impl``:

  * ``"cuda"``  — the hand-written CUDA kernel (CUDA tensors only),
  * ``"torch"`` — the plain PyTorch version (any device),
  * ``"auto"``  — ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.

There is no fallback: ``auto`` on a CUDA tensor launches the kernel or
raises.  Model code calls these wrappers with the JAX package's layouts.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "paged_prefill_attention", "resolve_impl", "KERNELS", "IMPLS"]

IMPLS = ("auto", "torch", "cuda")

#: every CUDA kernel on the serving path (build, launch counts)
KERNELS = (_decode.KERNEL, _flash.KERNEL, _decode.VERIFY_KERNEL)


def resolve_impl(impl: str, x) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected {IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if x.is_cuda else "torch"


def _no_scales(k_scales, v_scales) -> None:
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized pools (k_scales/v_scales) are not ported yet")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           impl: str = "auto", k_scales=None, v_scales=None):
    """q: (B, H, D); k/v_pages: (N, page, Hkv, D) pool layout;
    page_table: (B, pages_per_seq) frame ids; lengths: (B,) valid KV.
    Returns (B, H, D) in q's dtype."""
    _no_scales(k_scales, v_scales)
    if resolve_impl(impl, q) == "torch":
        return _decode.paged_decode_attention_torch(
            q, k_pages, v_pages, page_table, lengths)
    return _decode.paged_decode_attention_cuda(
        q, k_pages, v_pages, page_table, lengths)


def paged_verify_attention(q, k_pages, v_pages, page_table, lengths, *,
                           impl: str = "auto", k_scales=None, v_scales=None):
    """Speculative verify-K attention: q (B, S, H, D) — S = K + 1 verify
    rows per sequence; k/v_pages (N, page, Hkv, D) pool layout;
    page_table (B, pages_per_seq) frame ids; lengths (B, S) valid KV per
    row.  Returns (B, S, H, D) in q's dtype.  Rows with ``lengths == 0``
    are don't-care (zeros from the kernel, a uniform average from the
    plain version)."""
    _no_scales(k_scales, v_scales)
    if resolve_impl(impl, q) == "torch":
        return _decode.paged_verify_attention_torch(
            q, k_pages, v_pages, page_table, lengths)
    return _decode.paged_verify_attention_cuda(
        q, k_pages, v_pages, page_table, lengths)


def paged_prefill_attention(q, k_pages, v_pages, page_rows, offset, lengths,
                            *, window: int = 0, impl: str = "auto",
                            k_scales=None, v_scales=None):
    """Prompt-chunk attention over the paged KV pool (chunked prefill).

    q: (C, T, H, D) — one prompt chunk per row, model layout;
    k/v_pages: (N, page, Hkv, D) pool layout; page_rows: (C, pages_per_seq)
    frame ids; offset/lengths: (C,) absolute start + valid tokens per row.
    Rows at or past ``lengths`` are don't-care.  Returns q's shape and
    dtype."""
    _no_scales(k_scales, v_scales)
    if resolve_impl(impl, q) == "torch":
        return _flash.paged_prefill_attention_torch(
            q, k_pages, v_pages, page_rows, offset, lengths, window=window)
    return _flash.paged_prefill_attention_cuda(
        q, k_pages, v_pages, page_rows, offset, lengths, window=window)
