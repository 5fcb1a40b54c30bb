"""Paged decode and verify attention: the CUDA kernels and their plain
versions.

Two CUDA kernels, instances of one template (``csrc/paged_attention.cuh``,
design notes there), both bound by the bytes of K/V they read and both
split over the KV positions (flash-decoding): the table's capacity is
cut into ranges of :func:`paged_split_positions` positions (whole
64-position tiles, from B, Hkv, G, the capacity and the SM count, never
from the lengths, which stay on the device), one block per range, and
the combine of ``csrc/split_kv.cuh``, enqueued by the same call, merges
each row's ranges below its length from a workspace the wrapper
allocates:

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
point per dtype (f32, bf16).  It splits the positions over blocks
(flash-decoding): :func:`decode_splits` picks the number of ranges,
:func:`split_ranges` says which positions each covers, and a second
kernel enqueued by the same call merges the ranges' f32 partial states
from a workspace the wrapper allocates (``csrc/split_kv.cuh``).  Its
plain version :func:`decode_attention_torch` is the reference's
``decode_attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.build import (POOL_DTYPES, check_aligned,
                                      check_dense, check_heads,
                                      check_operand,
                                      dense_kernels, kernel_per_dtype,
                                      scale_pointers)
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["NEG_INF", "one_token_attention", "multi_token_attention",
           "paged_decode_attention_torch", "paged_decode_attention_cuda",
           "paged_verify_attention_torch", "paged_verify_attention_cuda",
           "decode_attention_torch", "decode_attention_cuda",
           "decode_splits", "split_ranges", "paged_split_positions",
           "paged_split_ranges", "paged_split_plan", "sm_count", "smem_optin",
           "KERNEL", "VERIFY_KERNEL",
           "KERNELS", "VERIFY_KERNELS", "DENSE_KERNELS"]

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: entry point per pool dtype: q, k_pages, v_pages, page_table, lengths,
#: out, the split workspace, B, (verify: S,) H, Hkv, D, page,
#: pages_per_seq, split_positions, scale, stream; the int8/fp8 ones take
#: k_scales, v_scales after v_pages
KERNELS = kernel_per_dtype("paged_decode.cu", "paged_decode_attention",
                           [_P] * 7 + [_I] * 7 + [_F, _P])
VERIFY_KERNELS = kernel_per_dtype("paged_verify.cu", "paged_verify_attention",
                                  [_P] * 7 + [_I] * 8 + [_F, _P])
KERNEL = KERNELS[torch.bfloat16]
VERIFY_KERNEL = VERIFY_KERNELS[torch.bfloat16]
#: the dense kernel's entry point per dtype of q, k, v and out: q, k, v,
#: out, the split workspace, B, Skv, H, Hkv, D, valid_len, splits, scale,
#: stream
DENSE_KERNELS = dense_kernels(
    "decode_attention.cu", "decode_attention",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P])
#: positions per tile of the dense kernel; a range spans at least
#: SPLIT_MIN_POSITIONS of them (csrc/decode_attention.cu kTile)
SPLIT_TILE = 64
SPLIT_MIN_POSITIONS = 256
#: query heads a dense decode block may hold (csrc kRowCounts)
_ROW_COUNTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16)
#: a paged range spans at least this many positions (whole tiles), unless
#: the table holds fewer; the ranges over the whole table make this many
#: decode blocks an SM (rows fill part of their table: at phase 2's and
#: the engine's lengths that leaves two or more live blocks an SM)
PAGED_SPLIT_MIN_POSITIONS = 128
PAGED_SPLIT_BLOCKS_PER_SM = 5


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """The SM count of ``dev`` (a CUDA device), cached per device."""
    return _sm_count(_index(dev))


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return props.shared_memory_per_block_optin


def smem_optin(dev) -> int:
    """The shared memory a block of ``dev`` may opt in to, in bytes,
    cached per device."""
    return _smem_optin(_index(dev))


def _index(dev) -> int:
    dev = torch.device(dev)
    return torch.cuda.current_device() if dev.index is None else dev.index


def _launch(kernels, name, q, k_pages, v_pages, page_table, lengths,
            k_scales, v_scales, *, verify: bool,
            split_positions: Optional[int]):
    """Check the operands of the decode / verify kernel (bf16 q; a bf16,
    int8 or fp8 pool, 16-byte aligned, with (N, Hkv) f32 scales for the
    last two; int32 table and lengths; q (B, H, D) and lengths (B,) for
    decode, q (B, S, H, D) and lengths (B, S) for verify), pick the
    entry point by pool dtype and the range length (default
    :func:`paged_split_positions`), allocate the output and, with more
    than one range, the workspace of B * S * H * n_ranges * (D + 2) f32;
    launch."""
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
    check_aligned(k_pages=k_pages, v_pages=v_pages)
    pps = page_table.shape[1]
    split_positions, _, ws_size = paged_split_plan(
        tuple(q.shape), tuple(k_pages.shape), pps, sm_count(dev),
        split_positions)
    out = torch.empty_like(q)
    rows = (q.shape[1],) if verify else ()
    ws = (torch.empty(ws_size, dtype=torch.float32, device=dev)
          if ws_size else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        kernels[k_pages.dtype].launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), B, *rows,
            H, Hkv, D, page, pps, split_positions, 1.0 / math.sqrt(D),
            stream)
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                k_scales=None, v_scales=None, *,
                                split_positions: Optional[int] = None):
    """Launch the decode kernel: q (B, H, D) bf16, lengths (B,) int32.
    ``split_positions`` (default :func:`paged_split_positions`) forces the
    range length, a multiple of 64."""
    return _launch(KERNELS, "paged_decode_attention_cuda", q, k_pages,
                   v_pages, page_table, lengths, k_scales, v_scales,
                   verify=False, split_positions=split_positions)


def paged_verify_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                k_scales=None, v_scales=None, *,
                                split_positions: Optional[int] = None):
    """Launch the verify kernel: q (B, S, H, D) bf16, lengths (B, S)
    int32; ``split_positions`` as for decode (row s is bitwise the decode
    kernel at ``lengths[:, s]`` when both cut alike)."""
    return _launch(VERIFY_KERNELS, "paged_verify_attention_cuda", q,
                   k_pages, v_pages, page_table, lengths, k_scales, v_scales,
                   verify=True, split_positions=split_positions)


def decode_attention_torch(q, k, v, valid_len=None):
    """Plain version of the dense kernel, the reference's
    ``decode_attention_ref``: q (B, H, D); k/v (B, Skv, Hkv, D); the
    first ``valid_len`` positions (default Skv) of every sequence."""
    return decode_attention_ref(q, k, v,
                                k.shape[1] if valid_len is None else valid_len)


def _head_blocks(G: int) -> int:
    """Blocks over a KV head's G query heads (csrc ``rows_for``): the
    fewest of at most 16 heads each."""
    blocks = -(-G // _ROW_COUNTS[-1])
    share = -(-G // blocks)
    rows = next(r for r in _ROW_COUNTS if r >= share)
    return -(-G // rows)


def decode_splits(B: int, Hkv: int, G: int, valid_len: int,
                  sms: int) -> int:
    """Ranges the dense kernel cuts ``valid_len`` positions into, from the
    shape and the SM count alone: enough blocks for two per SM, each range
    at least 256 positions (the last may end sooner, at ``valid_len``),
    one range at ``valid_len`` <= 256; no range empty."""
    if valid_len <= SPLIT_MIN_POSITIONS:
        return 1
    blocks = B * Hkv * _head_blocks(G)
    want = -(-2 * sms // blocks)
    splits = max(1, min(want, valid_len // SPLIT_MIN_POSITIONS))
    tiles = -(-valid_len // SPLIT_TILE)
    return -(-tiles // -(-tiles // splits))


def split_ranges(valid_len: int, splits: int):
    """The positions [start, end) of each of ``splits`` ranges, as the
    kernel cuts them: whole tiles of 64, an equal count to each but the
    last, which ends at ``valid_len``; ranges past it are empty."""
    tiles = -(-valid_len // SPLIT_TILE)
    per = max(1, -(-tiles // splits)) * SPLIT_TILE
    return [(min(s * per, valid_len), min(s * per + per, valid_len))
            for s in range(splits)]


def paged_split_positions(B: int, Hkv: int, G: int, capacity: int,
                          sms: int) -> int:
    """Positions per range of the paged decode and verify kernels, a
    multiple of 64, from the batch, the KV heads, the group size G, the
    table's capacity (pages_per_seq * page) and the SM count alone —
    never S or the lengths (they stay on the device), so a verify call
    and the decode call it is held against cut every row alike.  Enough
    ranges for :data:`PAGED_SPLIT_BLOCKS_PER_SM` decode blocks an SM over
    the whole capacity, each at least :data:`PAGED_SPLIT_MIN_POSITIONS`
    positions; the capacity itself (one range, no combine) where that is
    all it holds.  On an H100 (132 SMs) a 2048-position table of 8 rows
    takes 192 at phi4-mini's heads (24/8) and 384 at olmoe's (16/16);
    ``tools/paged_split_sweep.py`` found no one length fastest at every
    case of one shape, and these within 2-26% of each case's fastest
    (6% at the engine's decode, 8% at phase 2's bf16 decode)."""
    tiles = max(1, -(-capacity // SPLIT_TILE))
    blocks = B * Hkv * _head_blocks(G)
    want = -(-PAGED_SPLIT_BLOCKS_PER_SM * sms // blocks)
    per = max(PAGED_SPLIT_MIN_POSITIONS // SPLIT_TILE, -(-tiles // want))
    return min(per, tiles) * SPLIT_TILE


def paged_split_ranges(capacity: int, split_positions: int):
    """The positions [start, end) of each range the paged kernels cut a
    table of ``capacity`` positions into: ``split_positions`` each, the
    last cut at the capacity.  A row of length L uses the first
    ceil(L / split_positions) of them."""
    return [(s, min(s + split_positions, capacity))
            for s in range(0, max(capacity, 1), split_positions)]


def paged_split_plan(q_shape, pool_shape, pages_per_seq: int, sms: int,
                     split_positions: Optional[int] = None):
    """How the paged wrappers cut a call: (positions per range, ranges,
    f32 elements of the workspace, 0 with one range) for q of shape
    (B, H, D) (decode) or (B, S, H, D) (verify) over a pool of shape
    (N, page, Hkv, D) and a table of ``pages_per_seq`` entries a row.
    ``split_positions`` forces the range length (a positive multiple of
    64; ValueError otherwise); the default, :func:`paged_split_positions`,
    reads B, Hkv, G and the capacity, not S."""
    B, H, D = q_shape[0], q_shape[-2], q_shape[-1]
    _, page, Hkv, _ = pool_shape
    capacity = pages_per_seq * page
    if split_positions is None:
        split_positions = paged_split_positions(B, Hkv, H // Hkv, capacity,
                                                sms)
    if split_positions < SPLIT_TILE or split_positions % SPLIT_TILE:
        raise ValueError(f"split_positions must be a positive multiple of "
                         f"{SPLIT_TILE}, got {split_positions}")
    n_ranges = -(-capacity // split_positions)
    rows = math.prod(q_shape[:-1])
    return (split_positions, n_ranges,
            rows * n_ranges * (D + 2) if n_ranges > 1 else 0)


def decode_attention_cuda(q, k, v, valid_len=None, *,
                          splits: Optional[int] = None):
    """Launch the dense kernel: q (B, H, D), k/v (B, Skv, Hkv, D), all f32
    or all bf16, contiguous; any G, a head dim of ``HEAD_DIMS``.
    ``splits`` (default :func:`decode_splits`) is the number of ranges
    the positions are cut into; with more than one, a workspace of
    B * H * splits * (D + 2) f32 holds their partial states."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, D), got {tuple(q.shape)}")
    check_dense("decode_attention_cuda", q, k, v)
    dev = q.device
    B, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    check_heads(H, Hkv, D)
    check_aligned(k=k, v=v)
    valid = Skv if valid_len is None else min(int(valid_len), Skv)
    if valid < 0:
        raise ValueError(f"valid_len must be at least 0, got {valid_len}")
    if splits is None:
        splits = decode_splits(B, Hkv, H // Hkv, valid, sm_count(dev))
    if splits < 1:
        raise ValueError(f"splits must be at least 1, got {splits}")
    out = torch.empty_like(q)
    ws = (torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        DENSE_KERNELS[q.dtype].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, Skv, H, Hkv, D, valid,
            splits, 1.0 / math.sqrt(D), stream)
    return out
