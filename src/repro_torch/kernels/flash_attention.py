"""Paged chunked-prefill attention: the CUDA kernels and their plain version.

Two CUDA kernels replace the TPU kernel ``paged_prefill_flash`` of
``src/repro/kernels/flash_attention.py`` (``_paged_prefill_kernel``, its
``pallas_call`` at line 279), one entry point per pool element type.  At
the main path's shapes it is bound by operations; the design notes are
in the sources:

* bf16, ``csrc/paged_prefill_sm90.cu``: the producer thread reads the
  chunk row's page table and issues TMA loads of the pages (boxes of
  ``gcd(page, 64)`` rows) into a ring of stages on
  mbarriers; two consumer warpgroups compute Q K^T and P V with
  ``wgmma``, the online softmax in f32 registers (``csrc/flash_sm90.cuh``,
  shared with the dense kernel).  Its tiles depend on the head dim alone
  (:func:`sm90_plan`).
* int8 and fp8, ``csrc/paged_prefill.cu``: the frames of a quantized
  pool with their per-(frame, KV head) f32 scales (the TPU kernel's
  quantized instance, its scale BlockSpecs at line 257), on the same
  block: the producer warpgroup copies the 1-byte rows and their scales
  through the page table by ``cp.async`` into a raw ring and widens the
  codes, exactly, into the bf16 stages the consumers read; the scales
  multiply the columns of S and of P outside the products (the plan:
  :func:`quant_prefill_plan`).

:func:`paged_prefill_attention_torch` is the plain PyTorch version of the
same function: gather each chunk row's page-table view of the pool, then
run :func:`chunked_attention` with a per-row ``q_offset`` — the
expressions of the JAX package's XLA path (``kernels/ops.py:171-185``,
the grouped f32-operand branch of ``models/attention.py::_chunked_core``),
on the dequantized view of a quantized pool.
The CPU tests run it, and ``chip_smoke.py`` holds the kernels against it
on the card.

The dense kernels replace the TPU kernel ``flash_attention`` of the same
file (``_flash_kernel``, its ``pallas_call`` at line 114): blocked flash
attention over a dense cache with static ``causal``, ``window``,
``q_offset`` and ``kv_valid``, read in the model layout, one entry point
per dtype: bf16 in ``csrc/flash_attention_sm90.cu`` (the design above,
TMA maps over q, k and v in place), f32 in ``csrc/flash_attention.cu``
(``mma.sync`` TF32 tensor-core products in 3xTF32, hi/lo split operands,
which keep the reference's f32 bar; rows a block and the KV split inside
it from :func:`f32_flash_plan`).  Its plain version
:func:`flash_attention_torch` is :func:`chunked_attention` with the
scalar ``q_offset`` broadcast over the batch and K/V cut to their first
``kv_valid`` positions — the same function.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import (POOL_DTYPES, CudaKernel,
                                      check_aligned, check_dense,
                                      check_heads, check_operand,
                                      dense_kernels, kernel_per_dtype,
                                      scale_pointers)
from repro_torch.kernels.decode_attention import (NEG_INF, gather_pages,
                                                  sm_count)

__all__ = ["chunked_attention", "paged_prefill_attention_torch",
           "paged_prefill_attention_cuda", "flash_attention_torch",
           "flash_attention_cuda", "sm90_plan", "Sm90Plan",
           "quant_prefill_plan", "QuantPrefillPlan",
           "f32_flash_plan", "f32_flash_smem", "f32_flash_stages",
           "F32_FLASH_WARPS_Q",
           "KERNEL", "KERNELS", "DENSE_KERNELS"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: entry point per pool dtype; the int8/fp8 ones take k_scales, v_scales
#: after v_pages
KERNELS = kernel_per_dtype(
    {torch.bfloat16: "paged_prefill_sm90.cu", torch.int8: "paged_prefill.cu",
     torch.float8_e4m3fn: "paged_prefill.cu"}, "paged_prefill_attention",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P])
KERNEL = KERNELS[torch.bfloat16]
_DENSE_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F]
#: the dense kernel's entry point per dtype of q, k, v and out: q, k, v,
#: out, B, Sq, Skv, H, Hkv, D, causal, window, q_offset, kv_valid, scale,
#: (f32: the plan's warps_q,) stream
DENSE_KERNELS = dense_kernels(
    {torch.float32: "flash_attention.cu",
     torch.bfloat16: "flash_attention_sm90.cu"}, "flash_attention",
    _DENSE_ARGS + [_P])
DENSE_KERNELS[torch.float32] = CudaKernel(
    "flash_attention.cu", "flash_attention_f32", _DENSE_ARGS + [_I, _P])

#: the f32 kernel's block (csrc/flash_attention.cu): warps, query rows a
#: warp, positions a ring stage; warps_q, the warps along the queries,
#: from :func:`f32_flash_plan`
F32_FLASH_WARPS, F32_FLASH_ROWS, F32_FLASH_BLOCK_KV = 4, 16, 32
F32_FLASH_WARPS_Q = (4, 2, 1)

#: the bf16 kernels' tiles (``csrc/flash_sm90.cuh``): query rows a block
#: (two consumer warpgroups of 64), KV positions a tile, ring stages, the
#: columns of one TMA box (128 bytes, the swizzle's span), and the slack
#: that aligns the shared memory to the swizzle's 1024-byte groups
SM90_BLOCK_Q, SM90_BLOCK_KV, SM90_STAGES, SM90_ATOM = 128, 64, 4, 64
_SM90_ALIGN = 1024


class Sm90Plan(NamedTuple):
    """The bf16 attention kernels' tiles for one head dim."""
    d_pad: int          # D padded to whole 64-column boxes
    block_q: int
    block_kv: int
    stages: int
    smem_bytes: int     # q tile, the ring, 2 * stages + 1 mbarriers


def sm90_plan(head_dim: int) -> Sm90Plan:
    """The bf16 kernels' plan for ``head_dim`` (csrc ``Plan<D>``): a
    function of the head dim alone, so no batch, chunk row or length
    changes a tile or the order of a row's sums."""
    d_pad = -(-head_dim // SM90_ATOM) * SM90_ATOM
    smem = (_SM90_ALIGN + SM90_BLOCK_Q * d_pad * 2
            + SM90_STAGES * 2 * SM90_BLOCK_KV * d_pad * 2
            + (2 * SM90_STAGES + 1) * 8)
    return Sm90Plan(d_pad, SM90_BLOCK_Q, SM90_BLOCK_KV, SM90_STAGES, smem)


#: the quantized paged prefill's (``csrc/paged_prefill.cu``): the threads
#: of its producer warpgroup, which copy and widen, and the raw ring's
#: stages
QUANT_PRODUCERS, QUANT_RAW_STAGES = 128, 3


class QuantPrefillPlan(NamedTuple):
    """The quantized paged prefill's shared memory for one head dim."""
    raw_stage_bytes: int   # a tile's 1-byte K and V rows and their scales
    scale_offset: int      # the bf16 stages' scales, after the barriers
    raw_offset: int        # the raw ring
    smem_bytes: int


def quant_prefill_plan(head_dim: int) -> QuantPrefillPlan:
    """The quantized kernel's plan (csrc ``QuantPlan<D>``): the bf16
    plan's q tile, stages and barriers (:func:`sm90_plan`), each stage's
    k and v scales, then :data:`QUANT_RAW_STAGES` raw stages; a function
    of the head dim alone."""
    bf16 = sm90_plan(head_dim)
    scale_bytes = 2 * SM90_BLOCK_KV * 4
    raw_tile = SM90_BLOCK_KV * head_dim          # 1-byte rows of K or V
    scale_offset = -(-(bf16.smem_bytes - _SM90_ALIGN) // 16) * 16
    raw_offset = scale_offset + SM90_STAGES * scale_bytes
    raw_stage = 2 * raw_tile + scale_bytes
    return QuantPrefillPlan(
        raw_stage, scale_offset, raw_offset,
        _SM90_ALIGN + raw_offset + QUANT_RAW_STAGES * raw_stage)


def f32_flash_plan(B: int, H: int, Sq: int, sms: int) -> int:
    """warps_q of the f32 kernel (csrc ``launch_d``): how many of a
    block's 4 warps stack along the queries, 16 rows each, the others
    splitting each stage's positions between them.  The most rows a
    block (4, 2, then 1) whose q-tiles x heads x batch fill ``sms`` SMs,
    else 1: fewer rows a block only where blocks would leave SMs idle,
    since each block reads the K/V it walks for its own rows; then fewer
    while that leaves the block count as it is (short Sq), which splits
    the positions at no cost in reads."""
    def blocks(wq):
        return -(-Sq // (F32_FLASH_ROWS * wq)) * H * B

    wq = next((w for w in F32_FLASH_WARPS_Q[:-1] if blocks(w) >= sms),
              F32_FLASH_WARPS_Q[-1])
    while wq > 1 and blocks(wq // 2) == blocks(wq):
        wq //= 2
    return wq


def f32_flash_stages(head_dim: int) -> int:
    """The f32 kernel's ring depth: 3, 2 at D 128 (two blocks an SM)."""
    return 2 if head_dim >= 128 else 3


def f32_flash_smem(head_dim: int) -> int:
    """Dynamic shared memory of an f32 block in bytes (csrc ``Layout``):
    the q tile and the ring of K and V stages, with padded rows, or the
    warps' partial states, which reuse them, if larger."""
    d = head_dim
    k_row = d if d % 32 == 16 else d + 16
    rows = F32_FLASH_WARPS * F32_FLASH_ROWS
    ring = f32_flash_stages(d) * F32_FLASH_BLOCK_KV * (k_row + d + 4)
    parts = rows * (d + 4 + 2)
    return 4 * max(rows * k_row + ring, parts)


def chunked_attention(q, k, v, *, q_offset, causal: bool = True,
                      window: int = 0, chunk: int = 1024,
                      kv_valid_len=None):
    """Blockwise online-softmax attention with per-row query offsets.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); ``q_offset`` (B,) is the
    absolute position of ``q[b, 0]``, which shifts the causal wedge (and
    the SWA ``window``) per row; ``kv_valid_len`` (B,), where given,
    masks each row's KV positions at or past it (the enc-dec chunk's
    cross attention: each row its own source length).  The KV axis is
    walked in ``chunk`` blocks with f32 operands and f32 accumulation,
    as the JAX package's grouped ``_chunked_core`` does.  Returns q's
    dtype.
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
        if kv_valid_len is not None:
            mask = mask & (kv_pos[None, None, :]
                           < kv_valid_len.reshape(-1, 1, 1))
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
    check_heads(H, Hkv, D)
    out = torch.empty_like(q)
    check_aligned(q=q, k_pages=k_pages, v_pages=v_pages, out=out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNELS[k_pages.dtype].launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, page_rows.data_ptr(), offset.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), C, T, H, Hkv, D, page,
            page_rows.shape[1], int(window), 1.0 / math.sqrt(D), stream)
    return out


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, kv_valid=None):
    """Plain version of the dense kernel: q (B, Sq, H, D); k/v (B, Skv,
    Hkv, D); ``q_offset`` the absolute position of ``q[:, 0]``; KV
    positions at or past ``kv_valid`` (default Skv) are masked."""
    if kv_valid is not None:
        k, v = k[:, :kv_valid], v[:, :kv_valid]
    offset = torch.full((q.shape[0],), q_offset, dtype=torch.int64,
                        device=q.device)
    return chunked_attention(q, k, v, q_offset=offset, causal=causal,
                             window=window)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, kv_valid=None,
                         warps_q: Optional[int] = None):
    """Launch the dense kernel: q (B, Sq, H, D), k/v (B, Skv, Hkv, D), all
    f32 or all bf16, contiguous, 16-byte aligned, any G, a head dim of
    ``HEAD_DIMS``.  ``warps_q`` forces the f32 kernel's plan (default
    :func:`f32_flash_plan`)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D), got {tuple(q.shape)}")
    check_dense("flash_attention_cuda", q, k, v)
    dev = q.device
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    check_heads(H, Hkv, D)
    out = torch.empty_like(q)
    check_aligned(q=q, k=k, v=v, out=out)
    plan = ()
    if q.dtype == torch.float32:
        if warps_q is None:
            warps_q = f32_flash_plan(B, H, Sq, sm_count(dev))
        if warps_q not in F32_FLASH_WARPS_Q:
            raise ValueError(f"warps_q must be one of {F32_FLASH_WARPS_Q}, "
                             f"got {warps_q}")
        plan = (warps_q,)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        DENSE_KERNELS[q.dtype].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, Hkv, D, int(causal), int(window), int(q_offset),
            Skv if kv_valid is None else int(kv_valid), 1.0 / math.sqrt(D),
            *plan, stream)
    return out
