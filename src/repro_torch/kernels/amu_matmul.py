"""AMU matmul: the CUDA kernels and their plain version.

Two CUDA kernels replace the TPU kernel ``amu_matmul`` of
``src/repro/kernels/amu_matmul.py`` (``_amu_matmul_kernel``, its
``pallas_call`` at line 117): the paper's aload / SPM / getfin model
inside one kernel.  Their design notes, and the line-by-line maps to the
TPU kernel, are in the sources.  One entry point per dtype (x, w and out
of the same type):

* bf16, ``csrc/amu_matmul_sm90.cu``: TMA loads into a ring of stages in
  shared memory, each completing on an mbarrier, issued by one producer
  thread; consumer warpgroups multiply with ``wgmma`` on the tensor cores.
  Its tile is the card's (:func:`sm90_tiles`).  TMA needs row strides of
  a multiple of 16 bytes (:func:`check_tma`).
* f32, ``csrc/amu_matmul.cu``: a ring of 4 stages per operand in
  shared memory filled by ``cp.async`` groups (x transposed to k-major on
  its way in), an 8 x 8 or 8 x 4 register tile per thread, products on
  the CUDA cores in f32 (``wgmma``'s only f32 mode is TF32, about 1e-3 relative,
  over the reference's 5e-6 bar).  Its tile is the card's too
  (:func:`f32_tiles`); ragged M and N are predicated, N a multiple of 4.

Tiles come from the SPM planner (:func:`repro_torch.core.spm.
plan_matmul_blocks`) as in the reference (``amu_matmul.py:106-112``),
planned against the card's opt-in shared memory per block — the SPM on
Hopper.  The planner counts a bm x bn f32 accumulator in that budget,
which the kernel keeps in registers, so where it finds no tiles within
it (f32 at 1024^3 and up) the reference's own plan (its default budget)
stands.  Both kernels validate the reference's tiles, planned or given
(:func:`plan_tiles`; for f32 also :func:`launch_tiles`, which refuses a
tile with no sub-tile of sides that are multiples of 8), and then run the
card's.  Each output element sums its K products in order, one f32 FMA
each, whatever the tile, so neither the reference's tiles nor the card's
change a bit of the f32 result.

:func:`amu_matmul_torch` is the plain version, the reference's
``matmul_ref``: an f32 product cast to x's dtype.  The CPU tests run it,
and ``chip_smoke.py`` holds the kernels against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.spm import plan_matmul_blocks
from repro_torch.kernels.build import (DENSE_DTYPES, CudaKernel,
                                      check_aligned, check_operand)
from repro_torch.kernels.ref import matmul_ref

__all__ = ["amu_matmul_torch", "amu_matmul_cuda", "plan_tiles",
           "launch_tiles", "k_substep", "f32_tiles", "f32_smem_bytes",
           "sm90_tiles", "sm90_stages", "sm90_smem_bytes", "check_tma",
           "KERNELS", "F32_TILES", "F32_STAGES"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, out, M, K, N, then the kernel's (bm, bn, stages), and the stream
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
#: entry point per dtype of x, w and out
KERNELS = {torch.float32: CudaKernel("amu_matmul.cu", "amu_matmul_f32",
                                     _ARGS),
           torch.bfloat16: CudaKernel("amu_matmul_sm90.cu",
                                      "amu_matmul_bf16", _ARGS)}
_MICRO = 8           # the reference tiles' sub-tile sides (launch_tiles)
_MAX_THREADS = 256   # threads of 8 x 8 outputs a sub-tile may need
_PIECE = 16          # bytes per cp.async copy and TMA's base alignment

#: the f32 kernel's block tiles (csrc/amu_matmul.cu: 8 x 8 outputs a
#: thread in 128 x 128, 8 x 4 in 64 x 64), each tile's K columns per ring
#: stage, the x tile's row padding and the ring's stages
F32_TILES = ((128, 128), (64, 64))
F32_BK = {(128, 128): 16, (64, 64): 32}
_F32_XPAD = 4
F32_STAGES = 4

#: the bf16 kernel's tiles (csrc/amu_matmul_sm90.cu): output rows per
#: block (one or two consumer warpgroups of 64 rows), output columns per
#: block (whole 64-column boxes of w, the 128-byte swizzle's span), K per
#: ring stage, the most stages it keeps, and the slack that aligns the
#: ring to the swizzle's 1024-byte groups
SM90_BM = (64, 128)
SM90_BN = (64, 128, 192, 256)
SM90_BK = 64
SM90_MAX_STAGES = 8
_SM90_ALIGN = 1024

amu_matmul_torch = matmul_ref


def plan_tiles(M: int, K: int, N: int, dtype_bytes: int, vmem_budget: int,
               bm: Optional[int] = None, bk: Optional[int] = None,
               bn: Optional[int] = None) -> Tuple[int, int, int]:
    """(bm, bk, bn): the given tiles, the missing ones from the planner,
    as the reference picks them, planned against ``vmem_budget`` or, where
    no tiles fit it, against the reference's default budget; ValueError
    unless they tile (M, K, N)."""
    if bm is None or bk is None or bn is None:
        pm, pk, pn = _planned(M, K, N, dtype_bytes, vmem_budget)
        bm, bk, bn = bm or pm, bk or pk, bn or pn
    if M % bm or K % bk or N % bn:
        raise ValueError(f"dims ({M},{K},{N}) must tile by ({bm},{bk},{bn})")
    return bm, bk, bn


@functools.lru_cache(maxsize=256)
def _planned(M: int, K: int, N: int, dtype_bytes: int,
             vmem_budget: int) -> Tuple[int, int, int]:
    """The planner's (bm, bk, bn) for these shapes, cut to them: a pure
    function of its arguments, kept so a call does not plan again."""
    try:
        plan = plan_matmul_blocks(M, K, N, dtype_bytes=dtype_bytes,
                                  vmem_budget=vmem_budget)
    except ValueError:      # the reference's plan: its accumulator
        plan = plan_matmul_blocks(M, K, N, dtype_bytes=dtype_bytes)
    return (min(plan.block_shapes["x"][0], M),
            min(plan.block_shapes["x"][1], K),
            min(plan.block_shapes["w"][1], N))


def f32_smem_bytes(bm: int, bn: int, stages: int = F32_STAGES) -> int:
    """Shared memory of the f32 kernel's (bm, bn) block: ``stages``
    stages of a k-major x tile (rows padded by 4 floats) and a w tile,
    each ``F32_BK[(bm, bn)]`` deep."""
    return stages * F32_BK[(bm, bn)] * (bm + _F32_XPAD + bn) * 4


@functools.lru_cache(maxsize=256)
def f32_tiles(M: int, N: int, sms: int,
              smem_bytes: int) -> Tuple[int, int, int]:
    """(bm, bn, stages) of the f32 kernel for an (M, N) output on a card
    of ``sms`` SMs: of :data:`F32_TILES`, the one that gives the busiest
    SM the fewest outputs, its share of the blocks (``ceil(blocks /
    sms)``) times a block's (bm * bn); of two that tie, the larger tile,
    which reads fewer bytes per output.  ``stages`` is
    :data:`F32_STAGES`; ValueError where that ring does not fit in
    ``smem_bytes``.  (``tools/f32_tile_sweep.py`` times every tile: this
    rule picked the fastest of the set at each of its shapes.)"""
    def cost(tile):
        bm, bn = tile
        blocks = -(-M // bm) * -(-N // bn)
        return -(-blocks // sms) * bm * bn, -bm * bn

    bm, bn = min(F32_TILES, key=cost)
    if f32_smem_bytes(bm, bn) > smem_bytes:
        raise ValueError(f"amu_matmul f32 kernel: {F32_STAGES} stages of a "
                         f"({bm}, {bn}) tile do not fit in {smem_bytes} "
                         f"bytes")
    return bm, bn, F32_STAGES


def sm90_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Shared memory of the bf16 kernel's block: ``stages`` stages of a
    bm x 64 x tile and a 64 x bn w tile in bf16 with two 8-byte
    mbarriers each, and 1 KiB to align the ring."""
    return _SM90_ALIGN + stages * ((bm + bn) * SM90_BK * 2 + 16)


def sm90_stages(bm: int, bn: int, smem_bytes: int) -> int:
    """The bf16 kernel's ring depth for a (bm, bn) tile: the most stages,
    at most 8, that fit in ``smem_bytes`` (csrc ``Tile::kStages``)."""
    per_stage = sm90_smem_bytes(bm, bn, 1) - _SM90_ALIGN
    return min(SM90_MAX_STAGES, (smem_bytes - _SM90_ALIGN) // per_stage)


@functools.lru_cache(maxsize=256)
def sm90_tiles(M: int, N: int, sms: int,
               smem_bytes: int) -> Tuple[int, int, int]:
    """(bm, bn, stages) of the bf16 kernel for an (M, N) output on a card
    of ``sms`` SMs: of the tiles it has, the one whose grid takes the
    least time, reckoned as the waves of blocks over the SMs times a
    block's work (bm * bn); of two that tie, the larger tile.  Stages
    from :func:`sm90_stages`; ValueError where fewer than two fit."""
    def cost(tile):
        bm, bn = tile
        blocks = -(-M // bm) * -(-N // bn)
        return -(-blocks // sms) * bm * bn, -bm * bn

    bm, bn = min(((bm, bn) for bm in SM90_BM for bn in SM90_BN), key=cost)
    stages = sm90_stages(bm, bn, smem_bytes)
    if stages < 2:
        raise ValueError(f"amu_matmul bf16 kernel: two stages of a ({bm}, "
                         f"{bn}) tile do not fit in {smem_bytes} bytes")
    return bm, bn, stages


def check_tma(K: int, N: int) -> None:
    """Raise ValueError unless TMA can read the rows of x (M, K) and w
    (K, N) in bf16: row strides that are multiples of 16 bytes, K and N
    multiples of 8 (the bases' 16-byte alignment is checked for both
    kernels)."""
    if K % 8 or N % 8:
        raise ValueError(f"amu_matmul bf16 kernel: TMA needs row strides "
                         f"of a multiple of 16 bytes, K ({K}) and N ({N}) "
                         f"multiples of 8")


@functools.lru_cache(maxsize=256)
def k_substep(bm: int, bk: int, bn: int, elem_bytes: int,
              smem_bytes: int) -> int:
    """The K step a (bm, bk, bn) tile of the reference maps to on the
    card: the largest divisor of ``bk`` that is a whole number of 16-byte
    copies and whose two slots of x and w fit in ``smem_bytes``.
    ValueError for a (bm, bn) tile a block cannot hold: a side not a
    multiple of 8, more than 256 threads of 8 x 8 outputs, or no K step
    that fits.  (The f32 path's check of the reference's tiles; the
    kernel runs :func:`f32_tiles`.)"""
    if bm % _MICRO or bn % _MICRO \
            or (bm // _MICRO) * (bn // _MICRO) > _MAX_THREADS:
        raise ValueError(
            f"amu_matmul kernel cannot hold a ({bm}, {bn}) output tile: "
            f"sides must be multiples of {_MICRO} and bm * bn at most "
            f"{_MAX_THREADS * _MICRO * _MICRO}")
    for bks in range(bk, 0, -1):
        if bk % bks == 0 and bks * elem_bytes % _PIECE == 0 \
                and 2 * (bm + bn) * bks * elem_bytes <= smem_bytes:
            return bks
    raise ValueError(f"amu_matmul kernel: no K step of bk={bk} fits two "
                     f"slots of ({bm}, {bn}) tiles in {smem_bytes} bytes")


@functools.lru_cache(maxsize=256)
def launch_tiles(bm: int, bk: int, bn: int, elem_bytes: int,
                 smem_bytes: int) -> Tuple[int, int, int]:
    """(tm, tn, bks): the block tile the reference's (bm, bk, bn) maps to
    on the card, and its K step — the f32 path's check that the
    reference's tiles are ones a block can run; the kernel then runs
    :func:`f32_tiles`, which changes no bit.  (tm, tn) is (bm, bn)
    where one block holds it, else the largest sub-tile one block holds
    — sides that are multiples of 8 dividing bm and bn, at most 256
    threads of 8 x 8 outputs, the squarer of two of one size — and bks is
    :func:`k_substep`'s for it.  ValueError where no such sub-tile
    exists (a side with no divisor that is a multiple of 8)."""
    def sides(b):
        return [s for s in range(_MICRO, b + 1, _MICRO) if b % s == 0]

    fits = [(tm, tn) for tm in sides(bm) for tn in sides(bn)
            if (tm // _MICRO) * (tn // _MICRO) <= _MAX_THREADS]
    if not fits:
        raise ValueError(
            f"amu_matmul kernel cannot hold a ({bm}, {bn}) output tile or "
            f"any sub-tile of it: sides must have divisors that are "
            f"multiples of {_MICRO}")
    tm, tn = max(fits, key=lambda t: (t[0] * t[1], -(t[0] + t[1]), t[1]))
    return tm, tn, k_substep(tm, bk, tn, elem_bytes, smem_bytes)


def amu_matmul_cuda(x, w, *, bm: Optional[int] = None,
                    bk: Optional[int] = None, bn: Optional[int] = None):
    """Launch the kernel of x's dtype: x (M, K) and w (K, N), both f32 or
    both bf16, contiguous, on one CUDA device.  Returns (M, N) in x's
    dtype.  The tiles are validated as the reference's (ValueError unless
    they tile the shapes, and for f32 unless :func:`launch_tiles` takes
    them); each kernel then runs its own (:func:`f32_tiles`,
    :func:`sm90_tiles`)."""
    if not x.is_cuda:
        raise ValueError("amu_matmul_cuda needs CUDA tensors")
    if x.dtype not in DENSE_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of "
                        f"{tuple(DENSE_DTYPES)}")
    check_operand("x", x, x.dtype, 2, x.device)
    check_operand("w", w, x.dtype, 2, x.device)
    (M, K), (K2, N) = x.shape, w.shape
    if K != K2 or not M * K * N:
        raise ValueError(f"matmul of {tuple(x.shape)} and {tuple(w.shape)}")
    props = torch.cuda.get_device_properties(x.device)
    smem = props.shared_memory_per_block_optin
    bm, bk, bn = plan_tiles(M, K, N, x.element_size(), smem, bm, bk, bn)
    sms = props.multi_processor_count
    if x.dtype == torch.bfloat16:
        check_tma(K, N)
        tile = sm90_tiles(M, N, sms, smem)
    else:
        launch_tiles(bm, bk, bn, x.element_size(), smem)
        tile = f32_tiles(M, N, sms, smem)
    check_aligned(x=x, w=w)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        KERNELS[x.dtype].launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                M, K, N, *tile, stream)
    return out
