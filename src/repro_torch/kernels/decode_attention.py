"""Paged decode and verify attention: the CUDA kernels and their plain
versions.

Two CUDA kernels, instances of one template (``csrc/paged_attention.cuh``,
design notes there), both bound by the bytes of K/V they read:

  * ``csrc/paged_decode.cu`` replaces the TPU kernel
    ``paged_decode_attention`` of ``src/repro/kernels/decode_attention.py``
    (``_paged_decode_kernel``, its ``pallas_call`` at line 254): one query
    row per sequence;
  * ``csrc/paged_verify.cu`` replaces ``paged_verify_attention`` of the
    same file (``_paged_verify_kernel``, its ``pallas_call`` at line 395):
    S = K + 1 query rows per sequence for speculative verify-K, each
    masked by its own length; row s is bitwise the decode kernel at
    ``lengths[:, s]``.

Each has one entry point per pool element type: bf16, and the int8 and
fp8 (e4m3) frames of a quantized pool, which take the per-(frame, KV
head) f32 scales ``k_scales``/``v_scales`` (N, Hkv) beside the pool and
dequantize each K/V element as it is loaded — the TPU kernels'
quantized instances (their scale BlockSpecs at lines 234 and 377).

:func:`paged_decode_attention_torch` and
:func:`paged_verify_attention_torch` are the plain PyTorch versions:
gather the page-table view of the pool, then run
:func:`one_token_attention` / :func:`multi_token_attention` — the
expressions of the JAX package's XLA paths (``kernels/ops.py:98-112`` and
``:131-147``), which dequantize the gathered view of a quantized pool
(``k.float() * ks``) first.  The CPU tests run them, and
``chip_smoke.py`` holds the kernels against them on the card.

The dense decode kernel (``csrc/decode_attention.cu``) replaces the TPU
kernel ``decode_attention`` of the same file (``_decode_kernel``, its
``pallas_call`` at line 109): one query token per sequence over a dense
(B, Skv, Hkv, D) cache, one scalar ``valid_len`` for the batch, one entry
point per dtype (f32, bf16).  Its plain version
:func:`decode_attention_torch` is the reference's
``decode_attention_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (POOL_DTYPES, check_dense,
                                      check_heads, check_operand,
                                      dense_kernels, kernel_per_dtype,
                                      scale_pointers)
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["NEG_INF", "one_token_attention", "multi_token_attention",
           "paged_decode_attention_torch", "paged_decode_attention_cuda",
           "paged_verify_attention_torch", "paged_verify_attention_cuda",
           "decode_attention_torch", "decode_attention_cuda",
           "KERNEL", "VERIFY_KERNEL", "KERNELS", "VERIFY_KERNELS",
           "DENSE_KERNELS"]

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: entry point per pool dtype; the int8/fp8 ones take k_scales, v_scales
#: after v_pages
KERNELS = kernel_per_dtype("paged_decode.cu", "paged_decode_attention",
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _P])
VERIFY_KERNELS = kernel_per_dtype("paged_verify.cu", "paged_verify_attention",
                                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _P])
KERNEL = KERNELS[torch.bfloat16]
VERIFY_KERNEL = VERIFY_KERNELS[torch.bfloat16]
#: the dense kernel's entry point per dtype of q, k, v and out
DENSE_KERNELS = dense_kernels(
    "decode_attention.cu", "decode_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P])


def one_token_attention(q, kc, vc, valid, num_kv_heads: int):
    """One-query-token attention over a dense (B, Skv, Hkv, D) cache.

    ``q``: (B, H, D); ``valid``: (B,) masks KV positions at/past it.
    Returns f32 (B, 1, H * D).  The expressions of the JAX package's
    ``models/attention.py::one_token_attention``: scale, grouped score
    einsum, mask, softmax, value einsum, all in f32.
    """
    B, H, hd = q.shape
    slots = kc.shape[1]
    qf = q.float() * (1.0 / math.sqrt(hd))
    qf = qf.reshape(B, num_kv_heads, H // num_kv_heads, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kc.float())
    kv_idx = torch.arange(slots, device=q.device)
    live = (kv_idx[None, :] < valid[:, None])[:, None, None, :]
    s = torch.where(live, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, vc.float())
    return out.reshape(B, 1, H * hd)


def multi_token_attention(q, kc, vc, valid, num_kv_heads: int):
    """S-query-row attention over a dense (B, Skv, Hkv, D) cache: the
    counterpart of the JAX package's ``models/attention.py::
    multi_token_attention``, the plain version of speculative verify.

    ``q``: (B, S, H, D); ``valid``: (B, S) masks KV positions at/past it
    independently per row.  Returns f32 (B, S, H * D).

    Row ``s`` is computed by :func:`one_token_attention` itself on
    ``q[:, s]`` and ``valid[:, s]``, so it is bitwise the one-token
    result by construction, on any device — the property speculative
    token-exactness rests on.  (One batched einsum over the S axis gave
    the same bits on the CPU, but nothing guarantees that a BLAS picks
    the same blocking for both shapes, and the JAX package's batched
    form does lose it on its toolchain.)
    """
    return torch.cat([one_token_attention(q[:, s], kc, vc, valid[:, s],
                                          num_kv_heads)
                      for s in range(q.shape[1])], dim=1)


def gather_pages(pool, page_table, scales=None):
    """(rows, pages_per_seq * page, Hkv, D) dense view of ``pool`` through
    ``page_table`` (rows, pages_per_seq).  With ``scales`` (N, Hkv) the
    pool is quantized: the view is gathered as bytes and dequantized,
    ``pool.float() * scales`` per (frame, KV head), in f32."""
    _, page, hkv, d = pool.shape
    idx = page_table.long()
    if scales is None:
        x = pool[idx]
    else:
        x = pool.view(torch.uint8)[idx].view(pool.dtype).float() \
            * scales[idx][:, :, None, :, None]
    return x.reshape(page_table.shape[0], -1, hkv, d)


def paged_decode_attention_torch(q, k_pages, v_pages, page_table, lengths,
                                 k_scales=None, v_scales=None):
    """Plain version: q (B, H, D); k/v_pages (N, page, Hkv, D);
    page_table (B, pages_per_seq) frame ids; lengths (B,) valid KV;
    ``k_scales``/``v_scales`` (N, Hkv) for an int8/fp8 pool."""
    B, H, D = q.shape
    Hkv = k_pages.shape[2]
    out = one_token_attention(q, gather_pages(k_pages, page_table, k_scales),
                              gather_pages(v_pages, page_table, v_scales),
                              lengths, Hkv)
    return out.reshape(B, H, D).to(q.dtype)


def paged_verify_attention_torch(q, k_pages, v_pages, page_table, lengths,
                                 k_scales=None, v_scales=None):
    """Plain version: q (B, S, H, D); k/v_pages (N, page, Hkv, D);
    page_table (B, pages_per_seq) frame ids; lengths (B, S) valid KV per
    row; scales as for decode.  A row with ``lengths == 0`` returns the
    uniform average of the gathered values (the kernel returns zeros);
    callers never read it."""
    B, S, H, D = q.shape
    Hkv = k_pages.shape[2]
    out = multi_token_attention(q, gather_pages(k_pages, page_table, k_scales),
                                gather_pages(v_pages, page_table, v_scales),
                                lengths, Hkv)
    return out.reshape(B, S, H, D).to(q.dtype)


def _launch(kernels, name, q, k_pages, v_pages, page_table, lengths,
            k_scales, v_scales, *, verify: bool):
    """Check the operands of the decode / verify kernel (bf16 q; a bf16,
    int8 or fp8 pool, with (N, Hkv) f32 scales for the last two; int32
    table and lengths; q (B, H, D) and lengths (B,) for decode,
    q (B, S, H, D) and lengths (B, S) for verify), pick the entry point
    by pool dtype, allocate the output, launch."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    dev = q.device
    ndim = 4 if verify else 3
    if k_pages.dtype not in POOL_DTYPES:
        raise TypeError(f"k_pages has dtype {k_pages.dtype}, expected one "
                        f"of {POOL_DTYPES}")
    check_operand("q", q, torch.bfloat16, ndim, dev)
    check_operand("k_pages", k_pages, k_pages.dtype, 4, dev)
    check_operand("v_pages", v_pages, k_pages.dtype, 4, dev)
    scale_ptrs = scale_pointers(k_scales, v_scales, dev)
    check_operand("page_table", page_table, torch.int32, 2, dev)
    check_operand("lengths", lengths, torch.int32, ndim - 2, dev)
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    N, page, Hkv, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if page_table.shape[0] != B or lengths.shape != q.shape[:-2]:
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match q "
                         f"{tuple(q.shape)}")
    check_heads(H, Hkv, D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = (q.shape[1],) if verify else ()
    with torch.cuda.device(dev):
        kernels[k_pages.dtype].launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, *rows, H, Hkv, D, page, page_table.shape[1],
            1.0 / math.sqrt(D), stream)
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                k_scales=None, v_scales=None):
    """Launch the decode kernel: q (B, H, D) bf16, lengths (B,) int32."""
    return _launch(KERNELS, "paged_decode_attention_cuda", q, k_pages,
                   v_pages, page_table, lengths, k_scales, v_scales,
                   verify=False)


def paged_verify_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                k_scales=None, v_scales=None):
    """Launch the verify kernel: q (B, S, H, D) bf16, lengths (B, S)
    int32."""
    return _launch(VERIFY_KERNELS, "paged_verify_attention_cuda", q,
                   k_pages, v_pages, page_table, lengths, k_scales, v_scales,
                   verify=True)


def decode_attention_torch(q, k, v, valid_len=None):
    """Plain version of the dense kernel, the reference's
    ``decode_attention_ref``: q (B, H, D); k/v (B, Skv, Hkv, D); the
    first ``valid_len`` positions (default Skv) of every sequence."""
    return decode_attention_ref(q, k, v,
                                k.shape[1] if valid_len is None else valid_len)


def decode_attention_cuda(q, k, v, valid_len=None):
    """Launch the dense kernel: q (B, H, D), k/v (B, Skv, Hkv, D), all f32
    or all bf16, contiguous; any G, a head dim of ``HEAD_DIMS``."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, D), got {tuple(q.shape)}")
    check_dense("decode_attention_cuda", q, k, v)
    dev = q.device
    B, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    check_heads(H, Hkv, D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        DENSE_KERNELS[q.dtype].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Skv,
            H, Hkv, D, Skv if valid_len is None else int(valid_len),
            1.0 / math.sqrt(D), stream)
    return out
