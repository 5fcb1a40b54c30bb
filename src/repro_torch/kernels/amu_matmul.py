"""AMU matmul: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/amu_matmul.cu``) replaces the TPU kernel
``amu_matmul`` of ``src/repro/kernels/amu_matmul.py``
(``_amu_matmul_kernel``, its ``pallas_call`` at line 117): the paper's
aload / SPM / getfin model inside one kernel, a two-slot shared-memory
ring per operand filled by ``cp.async`` groups, tile k + 2 issued into
the slot tile k has just freed.  Its design notes, and the line-by-line
map to the TPU kernel, are in the source.  One entry point per dtype:
f32 and bf16 (x, w and out of the same type).

Tiles come from the SPM planner (:func:`repro_torch.core.spm.
plan_matmul_blocks`) as in the reference (``amu_matmul.py:106-112``),
planned against the card's opt-in shared memory per block — the SPM on
Hopper.  The planner counts a bm x bn f32 accumulator in that budget,
which the kernel keeps in registers, so where it finds no tiles within
it (f32 at 1024^3 and up) the reference's own plan (its default budget)
stands.  The reference's tiles, planned or given, then map to the
kernel's launch tile (:func:`launch_tiles`): the tile itself where one
block holds it, else the largest sub-tile one block holds; a bk step
whose two slots do not fit is split into sub-steps (:func:`k_substep`).
Each output element sums its K products in order whatever the tiles, so
the tiles change no bit of the result.

:func:`amu_matmul_torch` is the plain version, the reference's
``matmul_ref``: an f32 product cast to x's dtype.  The CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.spm import plan_matmul_blocks
from repro_torch.kernels.build import (DENSE_DTYPES, check_operand,
                                      dense_kernels)
from repro_torch.kernels.ref import matmul_ref

__all__ = ["amu_matmul_torch", "amu_matmul_cuda", "plan_tiles",
           "launch_tiles", "k_substep", "KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: entry point per dtype of x, w and out
KERNELS = dense_kernels("amu_matmul.cu", "amu_matmul",
                        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
_MICRO = 8           # a thread's output tile is 8 x 8 (csrc kTM, kTN)
_MAX_THREADS = 256   # csrc kMaxThreads
_PIECE = 16          # bytes per cp.async copy

amu_matmul_torch = matmul_ref


def plan_tiles(M: int, K: int, N: int, dtype_bytes: int, vmem_budget: int,
               bm: Optional[int] = None, bk: Optional[int] = None,
               bn: Optional[int] = None) -> Tuple[int, int, int]:
    """(bm, bk, bn): the given tiles, the missing ones from the planner,
    as the reference picks them, planned against ``vmem_budget`` or, where
    no tiles fit it, against the reference's default budget; ValueError
    unless they tile (M, K, N)."""
    if bm is None or bk is None or bn is None:
        try:
            plan = plan_matmul_blocks(M, K, N, dtype_bytes=dtype_bytes,
                                      vmem_budget=vmem_budget)
        except ValueError:      # the reference's plan: its accumulator
            plan = plan_matmul_blocks(M, K, N, dtype_bytes=dtype_bytes)
        bm = bm or min(plan.block_shapes["x"][0], M)
        bk = bk or min(plan.block_shapes["x"][1], K)
        bn = bn or min(plan.block_shapes["w"][1], N)
    if M % bm or K % bk or N % bn:
        raise ValueError(f"dims ({M},{K},{N}) must tile by ({bm},{bk},{bn})")
    return bm, bk, bn


def k_substep(bm: int, bk: int, bn: int, elem_bytes: int,
              smem_bytes: int) -> int:
    """The kernel's K step: the largest divisor of ``bk`` that is a
    whole number of 16-byte copies and whose two slots of x and w fit in
    ``smem_bytes``.  ValueError for a (bm, bn) tile the kernel cannot
    hold: a side not a multiple of 8, more than 256 threads of 8 x 8
    outputs, or no K step that fits."""
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


def launch_tiles(bm: int, bk: int, bn: int, elem_bytes: int,
                 smem_bytes: int) -> Tuple[int, int, int]:
    """(tm, tn, bks): the kernel's launch tile for the reference's
    (bm, bk, bn) and its K step.  (tm, tn) is (bm, bn) where one block
    holds it, else the largest sub-tile one block holds — sides that are
    multiples of 8 dividing bm and bn, at most 256 threads of 8 x 8
    outputs, the squarer of two of one size — and bks is
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
    """Launch the kernel: x (M, K) and w (K, N), both f32 or both bf16,
    contiguous, on one CUDA device.  Returns (M, N) in x's dtype."""
    if not x.is_cuda:
        raise ValueError("amu_matmul_cuda needs CUDA tensors")
    if x.dtype not in DENSE_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of "
                        f"{tuple(DENSE_DTYPES)}")
    check_operand("x", x, x.dtype, 2, x.device)
    check_operand("w", w, x.dtype, 2, x.device)
    (M, K), (K2, N) = x.shape, w.shape
    if K != K2:
        raise ValueError(f"matmul of {tuple(x.shape)} and {tuple(w.shape)}")
    smem = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    bm, bk, bn = plan_tiles(M, K, N, x.element_size(), smem, bm, bk, bn)
    tm, tn, bks = launch_tiles(bm, bk, bn, x.element_size(), smem)
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % _PIECE:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        KERNELS[x.dtype].launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                M, K, N, tm, tn, bks, stream)
    return out
