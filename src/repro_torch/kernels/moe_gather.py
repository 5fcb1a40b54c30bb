"""Indexed row gathers — the AMU *gather pattern* at kernel level: the
CUDA kernels and their plain versions.

MoE dispatch (and paged-KV fetch) reduce to ``out[i] = src[idx[i]]`` for
a dynamic index vector.  The CUDA kernels (``csrc/moe_gather.cu``)
replace the two TPU kernels of ``src/repro/kernels/moe_gather.py``:

  * :func:`gather_rows` — ``_gather_rows_kernel``, its ``pallas_call``
    at line 70: one output block of ``rows_per_block`` rows per grid
    step, one copy per row;
  * :func:`gather_blocks` — ``_gather_blocks_kernel``, its
    ``pallas_call`` at line 104: output block i is the ``block_rows``
    rows of source block ``block_idx[i]``.

Their design notes and bound are in the source.  One entry point per
dtype of src and out (f32, bf16); the indices are int32.  Both run one
kernel whose grid comes from :func:`gather_plan` (the work and the SM
count; the source mirrors it): rows cut into pieces of a fixed byte
count, a thread a 16-byte piece, element by element where a row's bytes
or a base pointer are off the 16-byte grid.  A block gather is the row
gather over the view ``(N / block_rows, block_rows * d)``: its plan is
``gather_plan(Mb, block_rows * d * itemsize, ...)``.  Coalescing for
semi-sorted indices happens upstream, in
:class:`repro_torch.core.patterns.GatherPattern`, as in the reference.

``impl`` (the reference's ``interpret``): ``"cuda"`` launches the kernel
(CUDA tensors only), ``"torch"`` runs the plain version,
``torch.index_select``, and ``"auto"`` picks by the device of ``src``.
Both refuse, with ValueError, the shapes the reference asserts against.
An index outside ``[0, N)`` is outside the contract, as in the
reference, whose DMA does not check it: the plain version raises, the
kernel reads whatever lies there.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (DENSE_DTYPES, check_operand,
                                      dense_kernels, resolve_impl)
from repro_torch.kernels.ref import gather_rows_ref

__all__ = ["gather_rows", "gather_blocks", "gather_rows_torch",
           "gather_blocks_torch", "gather_rows_cuda", "gather_blocks_cuda",
           "gather_plan", "GatherPlan", "KERNELS", "BLOCK_KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P]
#: entry point per dtype of src and out: ``gather_rows``
KERNELS = dense_kernels("moe_gather.cu", "gather_rows", _ARGS)
#: entry point per dtype of src and out: ``gather_blocks``
BLOCK_KERNELS = dense_kernels("moe_gather.cu", "gather_blocks", _ARGS)

gather_rows_torch = gather_rows_ref

#: csrc/moe_gather.cu's plan: the most and fewest threads a block
MAX_THREADS, MIN_THREADS = 256, 32


class GatherPlan(NamedTuple):
    """How the row gather cuts M rows of ``row_bytes`` bytes."""
    route: str          # "vec" (16-byte pieces) or "elem" (an element each)
    piece_bytes: int    # bytes a piece, a thread's copy
    per_row: int        # pieces a row
    pieces: int         # M * per_row
    threads: int        # threads a block
    blocks: int


def gather_plan(M: int, row_bytes: int, sms: int, *, elem_bytes: int = 2,
                aligned: bool = True) -> GatherPlan:
    """The row gather's plan (csrc ``plan_of``).  Route: elem, a piece an
    element of ``elem_bytes``, where the row's bytes or a base pointer
    (``aligned``) are off the 16-byte grid, else vec, a piece 16 bytes.
    A block: the most threads, 256 down to 32, that still give every one
    of ``sms`` SMs a block."""
    vec = aligned and row_bytes % 16 == 0
    piece = 16 if vec else elem_bytes
    pieces = M * (row_bytes // piece)
    threads = MAX_THREADS
    while threads > MIN_THREADS and -(-pieces // threads) < sms:
        threads //= 2
    return GatherPlan("vec" if vec else "elem", piece, row_bytes // piece,
                      pieces, threads, -(-pieces // threads))


def gather_blocks_torch(src, block_idx, block_rows: int = 8):
    """Plain version: the ``block_rows``-row blocks of ``src`` at
    ``block_idx``, stacked; (len(block_idx) * block_rows, d)."""
    N, d = src.shape
    blocks = src.view(N // block_rows, block_rows, d)
    return blocks.index_select(0, block_idx).reshape(-1, d)


def _check_gather(src, idx, name: str) -> None:
    """Raise unless ``src`` is a contiguous 2-d CUDA tensor of a dense
    dtype and ``idx`` a contiguous 1-d int32 tensor on its device."""
    if not src.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if src.dtype not in DENSE_DTYPES:
        raise TypeError(f"src has dtype {src.dtype}, expected one of "
                        f"{tuple(DENSE_DTYPES)}")
    check_operand("src", src, src.dtype, 2, src.device)
    check_operand("idx", idx, torch.int32, 1, src.device)


def _launch(kernel, src, idx, out, arg: int) -> torch.Tensor:
    N, d = src.shape
    if idx.shape[0]:
        stream = torch.cuda.current_stream(src.device).cuda_stream
        with torch.cuda.device(src.device):
            kernel.launch(src.data_ptr(), idx.data_ptr(), out.data_ptr(), N,
                          d, idx.shape[0], arg, stream)
    return out


def gather_rows_cuda(src, idx, rows_per_block: int = 8):
    """Launch the kernel: src (N, d) f32 or bf16, idx (M,) int32, both
    contiguous on one CUDA device.  Returns (M, d) in src's dtype."""
    _check_gather(src, idx, "gather_rows_cuda")
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                      device=src.device)
    return _launch(KERNELS[src.dtype], src, idx, out, rows_per_block)


def gather_blocks_cuda(src, block_idx, block_rows: int = 8):
    """Launch the kernel: src (N, d) f32 or bf16 with N a multiple of
    ``block_rows``, block_idx (Mb,) int32.  Returns (Mb * block_rows, d)
    in src's dtype."""
    _check_gather(src, block_idx, "gather_blocks_cuda")
    out = torch.empty((block_idx.shape[0] * block_rows, src.shape[1]),
                      dtype=src.dtype, device=src.device)
    return _launch(BLOCK_KERNELS[src.dtype], src, block_idx, out, block_rows)


def gather_rows(src, idx, *, rows_per_block: int = 8, impl: str = "auto"):
    """out[i] = src[idx[i]]: src (N, d), idx (M,) int32.  ValueError
    unless ``rows_per_block`` divides M, as the reference asserts."""
    M = idx.shape[0]
    if rows_per_block <= 0 or M % rows_per_block:
        raise ValueError(f"M = {M} is not a multiple of rows_per_block = "
                         f"{rows_per_block}")
    if resolve_impl(impl, src) == "torch":
        return gather_rows_torch(src, idx)
    return gather_rows_cuda(src, idx, rows_per_block)


def gather_blocks(src, block_idx, *, block_rows: int = 8,
                  impl: str = "auto"):
    """Block-aligned gather: src (N, d) as N / block_rows blocks of
    ``block_rows`` rows; block_idx (Mb,) int32.  Returns
    (Mb * block_rows, d).  ValueError unless ``block_rows`` divides N, as
    the reference asserts."""
    N = src.shape[0]
    if block_rows <= 0 or N % block_rows:
        raise ValueError(f"N = {N} is not a multiple of block_rows = "
                         f"{block_rows}")
    if resolve_impl(impl, src) == "torch":
        return gather_blocks_torch(src, block_idx, block_rows)
    return gather_blocks_cuda(src, block_idx, block_rows)
