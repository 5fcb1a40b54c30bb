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

The kernel-level entry points :func:`matmul`, :func:`flash_attention`,
:func:`decode_attention`, :func:`wkv6`, :func:`ssd` and
:func:`gather_rows` are the reference's (``kernels/ops.py``), with its
signatures, layouts and keyword names, on f32 or bf16 operands.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import amu_matmul as _amu
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba2 as _mamba2
from repro_torch.kernels import moe_gather as _gather
from repro_torch.kernels import rwkv6 as _rwkv6
from repro_torch.kernels.build import IMPLS, resolve_impl
from repro_torch.kernels.kv_quant import QUANT_DTYPES

__all__ = ["matmul", "flash_attention", "decode_attention",
           "paged_decode_attention", "paged_verify_attention",
           "paged_prefill_attention", "wkv6", "ssd", "gather_rows",
           "resolve_impl", "KERNELS", "DENSE_KERNELS", "SSM_KERNELS",
           "GATHER_KERNELS", "IMPLS"]

#: every CUDA kernel on the serving path, one entry per pool dtype
#: (build, launch counts): decode, prefill, verify
KERNELS = (*_decode.KERNELS.values(), *_flash.KERNELS.values(),
           *_decode.VERIFY_KERNELS.values())
#: the CUDA kernels of the kernel-level entry points, one entry per
#: dtype (f32, bf16): matmul, dense flash attention, dense decode
DENSE_KERNELS = (*_amu.KERNELS.values(), *_flash.DENSE_KERNELS.values(),
                 *_decode.DENSE_KERNELS.values())
#: the CUDA kernels of the linear-recurrence entry points, one entry per
#: dtype (f32, bf16): wkv6 (RWKV-6), ssd (Mamba2)
SSM_KERNELS = (*_rwkv6.KERNELS.values(), *_mamba2.KERNELS.values())
#: the CUDA kernels of the indexed gathers, one entry per dtype (f32,
#: bf16): gather_rows (MoE dispatch and combine), gather_blocks
GATHER_KERNELS = (*_gather.KERNELS.values(),
                  *_gather.BLOCK_KERNELS.values())


def matmul(x, w, *, impl: str = "auto", bm: Optional[int] = None,
           bk: Optional[int] = None, bn: Optional[int] = None):
    """x (M, K) @ w (K, N) with f32 accumulation, in x's dtype.  The
    tiles (bm, bk, bn) default to the SPM planner's, as the reference
    plans them, and must tile the shapes (ValueError otherwise); the
    f32 path refuses a tile with a side that has no divisor that is a
    multiple of 8 (:func:`repro_torch.kernels.amu_matmul.launch_tiles`).
    Both kernels then run tiles of their own (:func:`~repro_torch.
    kernels.amu_matmul.f32_tiles`, :func:`~repro_torch.kernels.
    amu_matmul.sm90_tiles`), which change no bit of the f32 result; the
    bf16 kernel needs K and N multiples of 8.  The plain version
    takes no tiles, as the reference's XLA path."""
    if resolve_impl(impl, x) == "torch":
        return _amu.amu_matmul_torch(x, w)
    return _amu.amu_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto", q_offset: int = 0,
                    kv_valid: Optional[int] = None, bq: int = 128,
                    bkv: int = 128):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) — model layout.  Query t
    sits at position ``q_offset + t``; KV positions at or past
    ``kv_valid`` (default Skv, at least 1) are masked.  ``bq``/``bkv``
    are the TPU kernel's block shapes, accepted for its signature; the
    CUDA kernel's tiles are its own and, for every query that sees a key,
    the result does not depend on them."""
    if kv_valid is not None and kv_valid < 1:
        raise ValueError(f"kv_valid must be at least 1, got {kv_valid}")
    fn = (_flash.flash_attention_torch if resolve_impl(impl, q) == "torch"
          else _flash.flash_attention_cuda)
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid)


def decode_attention(q, k, v, *, valid_len: Optional[int] = None,
                     impl: str = "auto", bkv: int = 256):
    """q: (B, H, D); k/v: (B, Skv, Hkv, D); ``valid_len`` one scalar for
    the batch (default Skv).  ``bkv`` is the TPU kernel's block size,
    accepted for its signature (the CUDA kernel tiles by 64)."""
    if resolve_impl(impl, q) == "torch":
        return _decode.decode_attention_torch(q, k, v, valid_len)
    return _decode.decode_attention_cuda(q, k, v, valid_len)


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


def wkv6(r, k, v, w, u, *, impl: str = "auto", chunk: int = 64,
         initial_state=None, return_state: bool = False):
    """Chunked RWKV-6 WKV: r, k, w (B, T, H, K), w the log decay (<= 0);
    v (B, T, H, V); u (H, K) the bonus; ``initial_state`` (B, H, K, V) or
    None (zero).  Returns (B, T, H, V) in r's dtype, and with
    ``return_state`` the final (B, H, K, V) f32 state too.  The plain
    version pads a T that ``min(chunk, T)`` does not divide, as the
    reference's XLA path; the kernel refuses it (ValueError), as the TPU
    kernel asserts."""
    kw = dict(chunk=chunk, initial_state=initial_state,
              return_state=return_state)
    if resolve_impl(impl, r) == "torch":
        return _rwkv6.wkv6_torch(r, k, v, w, u, **kw)
    return _rwkv6.wkv6_cuda(r, k, v, w, u, **kw)


def ssd(x, dt, A, B, C, D, *, impl: str = "auto", chunk: int = 128,
        initial_state=None, return_state: bool = False):
    """Chunked Mamba2 SSD: x (B, T, H, P); dt (B, T, H) after the
    softplus; A, D (H,); B, C (B, T, N) shared by the heads;
    ``initial_state`` (B, H, N, P) or None (zero).  Returns (B, T, H, P)
    in x's dtype, and with ``return_state`` the final (B, H, N, P) f32
    state too.  T and the chunk as for :func:`wkv6`."""
    kw = dict(chunk=chunk, initial_state=initial_state,
              return_state=return_state)
    if resolve_impl(impl, x) == "torch":
        return _mamba2.ssd_torch(x, dt, A, B, C, D, **kw)
    return _mamba2.ssd_cuda(x, dt, A, B, C, D, **kw)


def gather_rows(src, idx, *, impl: str = "auto", **kw):
    """Row gather out[i] = src[idx[i]]: src (N, d) f32 or bf16, idx (M,)
    int32; ``rows_per_block`` (default 8) must divide M.  A gather moves
    bits only: kernel and plain version give the same output."""
    return _gather.gather_rows(src, idx, impl=impl, **kw)
