"""Chunked Mamba2 SSD: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/ssd.cu``) replaces the TPU kernel ``ssd`` of
``src/repro/kernels/mamba2.py`` (``_ssd_kernel``, its ``pallas_call`` at
line 93): the chunked linear recurrence with one scalar decay per head
and step and an N x P f32 state per (batch row, head) carried across
the chunks of the sequence.  Its design notes and bound are in the
source.  One entry point per dtype of x, B, C and the output (f32,
bf16); dt, A and D go in as f32, as the model computes them.

:func:`ssd_torch` is the plain version: the chunked form
:func:`repro_torch.models.ssm.ssd_chunked`, which is what the
reference's ``impl="xla"`` runs.  It pads a T that the chunk does not
divide; the kernel, like the TPU kernel, refuses one.  The CPU tests run
the plain version, and ``chip_smoke.py`` holds the kernel against it on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DENSE_DTYPES, check_operand,
                                      dense_kernels, kernel_chunk,
                                      state_slice)

__all__ = ["ssd_torch", "ssd_cuda", "smem_bytes", "KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: entry point per dtype of x, B, C and out
KERNELS = dense_kernels("ssd.cu", "ssd",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _P])


def ssd_torch(x, dt, A, B, C, D, chunk: int = 128):
    """Plain version: x (B, T, H, P); dt (B, T, H); A, D (H,); B, C
    (B, T, N).  Returns (B, T, H, P) in x's dtype."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def smem_bytes(N: int, c: int, pb: int) -> int:
    """Shared memory of one block (``csrc/ssd.cu``): B and C tiles of c
    rows of N + 1 floats, the x columns, the state slice, M and three
    c-vectors (L, dt and the state decay)."""
    return 4 * (2 * c * (N + 1) + c * pb + N * pb + c * c + 3 * c)


def ssd_cuda(x, dt, A, B, C, D, chunk: int = 128):
    """Launch the kernel: x (B, T, H, P), B and C (B, T, N), all f32 or
    all bf16, contiguous; dt (B, T, H), A and D (H,), widened to f32.
    ValueError unless ``min(chunk, T)`` divides T.  Returns (B, T, H, P)
    in x's dtype."""
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
    props = torch.cuda.get_device_properties(dev)
    pb = state_slice(P, Bb * H, props.multi_processor_count)
    if smem_bytes(N, c, pb) > props.shared_memory_per_block_optin:
        raise ValueError(f"ssd kernel: a chunk of {c} with N = {N} needs "
                         f"{smem_bytes(N, c, pb)} bytes of shared memory")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNELS[x.dtype].launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), out.data_ptr(), Bb, T, H, P, N, c,
            pb, stream)
    return out
