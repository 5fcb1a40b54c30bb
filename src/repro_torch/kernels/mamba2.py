"""Chunked Mamba2 SSD: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/ssd.cu``) replaces the TPU kernel ``ssd`` of
``src/repro/kernels/mamba2.py`` (``_ssd_kernel``, its ``pallas_call`` at
line 93): the chunked linear recurrence with one scalar decay per head
and step and an N x P f32 state per (batch row, head).  On the card it
is the Mamba-2 block decomposition: C B^T once per (batch row, piece)
for all heads, the segments' states from zero, a scan of them, then
every piece's outputs, with the products on the tensor cores;
:func:`ssd_plan` cuts the sequence, and the source's header gives the
design and its bound.  One entry point per dtype of x, B, C and the
output (f32, bf16); dt, A and D go in as f32, as the model computes them.

:func:`ssd_torch` is the plain version: the chunked form
:func:`repro_torch.models.ssm.ssd_chunked`, which is what the
reference's ``impl="xla"`` runs.  It pads a T that the chunk does not
divide; the kernel, like the TPU kernel, refuses one.  The CPU tests run
the plain version, and ``chip_smoke.py`` holds the kernel against it on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import (DENSE_DTYPES, SMEM_OPTIN,
                                      RecurrencePlan, check_operand,
                                      dense_kernels, kernel_chunk,
                                      recurrence_plan)
from repro_torch.kernels.decode_attention import sm_count, smem_optin

__all__ = ["ssd_torch", "ssd_cuda", "ssd_plan", "ssd_smem", "P_WIDTHS",
           "N_WIDTHS", "KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: head and state widths P, N with an instance in ``csrc/ssd.cu``
P_WIDTHS, N_WIDTHS = (32, 64, 128), (16, 32, 64, 128)
#: entry point per dtype of x, B, C and out
KERNELS = dense_kernels("ssd.cu", "ssd",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P])


def ssd_torch(x, dt, A, B, C, D, chunk: int = 128):
    """Plain version: x (B, T, H, P); dt (B, T, H); A, D (H,); B, C
    (B, T, N).  Returns (B, T, H, P) in x's dtype."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def ssd_smem(P: int, N: int, cp: int, outputs: bool = True,
             update: bool = True) -> int:
    """Shared memory of a block of ``csrc/ssd.cu`` (its ``Layout``) at cp
    padded rows: x and the state at P + 8 floats a row, L and dt; with
    ``update`` B at N + 8; with ``outputs`` C at N + 4 and C B^T at cp + 4.
    A block of (A) is also at least a C B^T block: C and B at N + 4."""
    n = cp * (P + 8) + N * (P + 8) + 2 * cp
    if update:
        n += cp * (N + 8)
    if outputs:
        n += cp * (N + 4) + cp * (cp + 4)
    else:
        n = max(n, 2 * cp * (N + 4))
    return 4 * n


@functools.lru_cache(maxsize=256)
def ssd_plan(B: int, T: int, H: int, P: int, N: int, chunk: int, sms: int,
             smem_limit: int = SMEM_OPTIN, rows: Optional[int] = None,
             seg: Optional[int] = None) -> RecurrencePlan:
    """How ``csrc/ssd.cu`` runs these shapes on ``sms`` SMs
    (:func:`repro_torch.kernels.build.recurrence_plan`): pieces, segments,
    the blocks of its three kernels (the first also computes each
    piece's C B^T, a block per (batch row, piece)), the workspace (every
    piece's cp x cp C B^T, then each segment but the last: its N x P
    state and its log decay, f32) and the shared memory of its largest
    block.  ValueError unless the chunk divides T and P and N are widths
    the source has an instance for (:data:`P_WIDTHS`, :data:`N_WIDTHS`)."""
    c = kernel_chunk("ssd", T, chunk)
    if P not in P_WIDTHS or N not in N_WIDTHS:
        raise ValueError(f"ssd kernel: P = {P} must be one of {P_WIDTHS} "
                         f"and N = {N} one of {N_WIDTHS}")

    def cb(rows: int):
        cp = -(-rows // 16) * 16
        return B * (T // rows) * cp * cp, B * (T // rows)

    return recurrence_plan(
        "ssd", T, c, B * H, sms,
        lambda cp, outputs, update: ssd_smem(P, N, cp, outputs, update),
        (N, P, 1), cb, smem_limit=smem_limit, rows=rows, seg=seg)


def ssd_cuda(x, dt, A, B, C, D, chunk: int = 128,
             rows: Optional[int] = None, seg: Optional[int] = None):
    """Launch the kernel: x (B, T, H, P), B and C (B, T, N), all f32 or
    all bf16, contiguous; dt (B, T, H), A and D (H,), widened to f32.
    ValueError unless ``min(chunk, T)`` divides T.  ``rows`` / ``seg``
    force the plan's pieces and segments.  Returns (B, T, H, P) in x's
    dtype."""
    Bb, T, H, P = x.shape
    c = kernel_chunk("ssd", T, chunk)
    if not x.is_cuda:
        raise ValueError("ssd_cuda needs CUDA tensors")
    if x.dtype not in DENSE_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of "
                        f"{tuple(DENSE_DTYPES)}")
    dev = x.device
    dt, A, D = dt.float(), A.float(), D.float()
    check_operand("x", x, x.dtype, 4, dev)
    check_operand("B", B, x.dtype, 3, dev)
    check_operand("C", C, x.dtype, 3, dev)
    check_operand("dt", dt, torch.float32, 3, dev)
    check_operand("A", A, torch.float32, 1, dev)
    check_operand("D", D, torch.float32, 1, dev)
    N = B.shape[-1]
    if B.shape[:2] != (Bb, T) or C.shape != B.shape \
            or dt.shape != (Bb, T, H) or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"ssd shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} do not match")
    plan = ssd_plan(Bb, T, H, P, N, c, sm_count(dev), smem_optin(dev),
                    rows=rows, seg=seg)
    out = torch.empty_like(x)
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNELS[x.dtype].launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), out.data_ptr(), ws.data_ptr(), Bb,
            T, H, P, N, plan.rows, plan.seg, stream)
    return out
