"""Paged one-token decode attention: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/paged_decode.cu``) replaces the TPU kernel
``paged_decode_attention`` of ``src/repro/kernels/decode_attention.py``
(``_paged_decode_kernel``, its ``pallas_call`` at line 254).  It is bound
by the bytes of K/V it reads; its design notes are in the source.

:func:`paged_decode_attention_torch` is the plain PyTorch version of the
same function: gather the page-table view of the pool, then run
:func:`one_token_attention` — the expressions of the JAX package's XLA
path (``kernels/ops.py:98-112``).  The CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel, check_operand

__all__ = ["NEG_INF", "one_token_attention", "paged_decode_attention_torch",
           "paged_decode_attention_cuda", "KERNEL"]

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("paged_decode.cu", "paged_decode_attention_bf16",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P])
_GROUPS = (1, 2, 3, 4, 6, 8)
_HEAD_DIMS = (64, 128)


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


def paged_decode_attention_torch(q, k_pages, v_pages, page_table, lengths):
    """Plain version: q (B, H, D); k/v_pages (N, page, Hkv, D);
    page_table (B, pages_per_seq) frame ids; lengths (B,) valid KV."""
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    idx = page_table.long()
    k = k_pages[idx].reshape(B, -1, Hkv, D)        # (B, pps * page, Hkv, D)
    v = v_pages[idx].reshape(B, -1, Hkv, D)
    out = one_token_attention(q, k, v, lengths, Hkv)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths):
    """Launch the CUDA kernel (bf16 q and pool, int32 table and lengths)."""
    if not q.is_cuda:
        raise ValueError("paged_decode_attention_cuda needs CUDA tensors")
    dev = q.device
    check_operand("q", q, torch.bfloat16, 3, dev)
    check_operand("k_pages", k_pages, torch.bfloat16, 4, dev)
    check_operand("v_pages", v_pages, torch.bfloat16, 4, dev)
    check_operand("page_table", page_table, torch.int32, 2, dev)
    check_operand("lengths", lengths, torch.int32, 1, dev)
    B, H, D = q.shape
    N, page, Hkv, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("page_table / lengths batch does not match q")
    if H % Hkv or H // Hkv not in _GROUPS or D not in _HEAD_DIMS:
        raise ValueError(f"unsupported heads {H}/{Hkv} or head_dim {D} "
                         f"(groups {_GROUPS}, head_dim {_HEAD_DIMS})")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      page_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), B, H, Hkv, D, page,
                      page_table.shape[1], 1.0 / math.sqrt(D), stream)
    return out
