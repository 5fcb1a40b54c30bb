"""Paged chunked-prefill attention: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/paged_prefill.cu``) replaces the TPU kernel
``paged_prefill_flash`` of ``src/repro/kernels/flash_attention.py``
(``_paged_prefill_kernel``, its ``pallas_call`` at line 279).  At the
main path's shapes it is bound by operations; its design notes are in the
source.  It has one entry point per pool element type: bf16, and the
int8 and fp8 frames of a quantized pool, which take the per-(frame, KV
head) f32 scales (the TPU kernel's quantized instance, its scale
BlockSpecs at line 257) and dequantize each K/V element as it is staged.

:func:`paged_prefill_attention_torch` is the plain PyTorch version of the
same function: gather each chunk row's page-table view of the pool, then
run :func:`chunked_attention` with a per-row ``q_offset`` — the
expressions of the JAX package's XLA path (``kernels/ops.py:171-185``,
the grouped f32-operand branch of ``models/attention.py::_chunked_core``),
on the dequantized view of a quantized pool.
The CPU tests run it, and ``chip_smoke.py`` holds the kernel against it
on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (POOL_DTYPES, check_operand,
                                      kernel_per_dtype, scale_pointers)
from repro_torch.kernels.decode_attention import NEG_INF, gather_pages

__all__ = ["chunked_attention", "paged_prefill_attention_torch",
           "paged_prefill_attention_cuda", "KERNEL", "KERNELS"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: entry point per pool dtype; the int8/fp8 ones take k_scales, v_scales
#: after v_pages
KERNELS = kernel_per_dtype("paged_prefill.cu", "paged_prefill_attention",
                           [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _P])
KERNEL = KERNELS[torch.bfloat16]
_HEAD_DIMS = (64, 128)


def chunked_attention(q, k, v, *, q_offset, causal: bool = True,
                      window: int = 0, chunk: int = 1024):
    """Blockwise online-softmax attention with per-row query offsets.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); ``q_offset`` (B,) is the
    absolute position of ``q[b, 0]``, which shifts the causal wedge (and
    the SWA ``window``) per row.  The KV axis is walked in ``chunk``
    blocks with f32 operands and f32 accumulation, as the JAX package's
    grouped ``_chunked_core`` does.  Returns q's dtype.
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qs = q.float().reshape(B, Sq, Hkv, g, D)
    q_pos = (q_offset.reshape(-1, 1)
             + torch.arange(Sq, device=q.device))          # (B, Sq)
    acc = torch.zeros((B, Sq, Hkv, g, D), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Sq, Hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, g), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk].float()
        vci = v[:, ci * chunk:(ci + 1) * chunk].float()
        kv_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs, kci) * scale
        mask = (kv_pos < Skv)[None, None, :].expand(q_pos.shape[0], Sq, chunk)
        if causal:
            mask = mask & (q_pos[..., None] >= kv_pos[None, None, :])
        if window:
            mask = mask & (kv_pos[None, None, :] > q_pos[..., None] - window)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p, vci)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def paged_prefill_attention_torch(q, k_pages, v_pages, page_rows, offset,
                                  lengths, *, window: int = 0,
                                  k_scales=None, v_scales=None):
    """Plain version: q (C, T, H, D); k/v_pages (N, page, Hkv, D);
    page_rows (C, pages_per_seq); offset / lengths (C,);
    ``k_scales``/``v_scales`` (N, Hkv) for an int8/fp8 pool.  Rows at or
    past ``lengths`` are don't-care, as in the kernel."""
    k = gather_pages(k_pages, page_rows, k_scales)   # (C, pps * page, Hkv, D)
    v = gather_pages(v_pages, page_rows, v_scales)
    return chunked_attention(q, k, v, q_offset=offset, causal=True,
                             window=window)


def paged_prefill_attention_cuda(q, k_pages, v_pages, page_rows, offset,
                                 lengths, *, window: int = 0,
                                 k_scales=None, v_scales=None):
    """Launch the CUDA kernel (bf16 q; a bf16 pool, or an int8/fp8 pool
    with (N, Hkv) f32 scales; int32 rows/offset/lengths), the entry
    point picked by pool dtype."""
    if not q.is_cuda:
        raise ValueError("paged_prefill_attention_cuda needs CUDA tensors")
    dev = q.device
    if k_pages.dtype not in POOL_DTYPES:
        raise TypeError(f"k_pages has dtype {k_pages.dtype}, expected one "
                        f"of {POOL_DTYPES}")
    check_operand("q", q, torch.bfloat16, 4, dev)
    check_operand("k_pages", k_pages, k_pages.dtype, 4, dev)
    check_operand("v_pages", v_pages, k_pages.dtype, 4, dev)
    scale_ptrs = scale_pointers(k_scales, v_scales, dev)
    check_operand("page_rows", page_rows, torch.int32, 2, dev)
    check_operand("offset", offset, torch.int32, 1, dev)
    check_operand("lengths", lengths, torch.int32, 1, dev)
    C, T, H, D = q.shape
    N, page, Hkv, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if page_rows.shape[0] != C or offset.shape[0] != C \
            or lengths.shape[0] != C:
        raise ValueError("page_rows / offset / lengths rows do not match q")
    if H % Hkv or D not in _HEAD_DIMS:
        raise ValueError(f"unsupported heads {H}/{Hkv} or head_dim {D} "
                         f"(head_dim {_HEAD_DIMS})")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNELS[k_pages.dtype].launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, page_rows.data_ptr(), offset.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), C, T, H, Hkv, D, page,
            page_rows.shape[1], int(window), 1.0 / math.sqrt(D), stream)
    return out
