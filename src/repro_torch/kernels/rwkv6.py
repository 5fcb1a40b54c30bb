"""Chunked RWKV-6 WKV: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/wkv6.cu``) replaces the TPU kernel ``wkv6`` of
``src/repro/kernels/rwkv6.py`` (``_wkv6_kernel``, its ``pallas_call`` at
line 93): the chunked linear recurrence with a K x V f32 state per
(batch row, head) carried across the chunks of the sequence.  Its design
notes and bound are in the source.  One entry point per dtype of r, k, v
and the output (f32, bf16); w (the log decay) and u (the bonus) go in
as f32, the decay path of the model.

:func:`wkv6_torch` is the plain version: the chunked form
:func:`repro_torch.models.ssm.wkv6_chunked`, which is what the
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

__all__ = ["wkv6_torch", "wkv6_cuda", "smem_bytes", "KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: entry point per dtype of r, k, v and out
KERNELS = dense_kernels("wkv6.cu", "wkv6",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P])


def wkv6_torch(r, k, v, w, u, chunk: int = 64):
    """Plain version: r, k, w (B, T, H, K); v (B, T, H, V); u (H, K).
    Returns (B, T, H, V) in r's dtype."""
    from repro_torch.models.ssm import wkv6_chunked
    return wkv6_chunked(r, k, v, w, u, chunk=chunk)


def smem_bytes(K: int, c: int, vb: int) -> int:
    """Shared memory of one block (``csrc/wkv6.cu``): r, k, W and
    W_{t-1} tiles of c rows of K + 1 floats, the v columns, the state
    slice, att and u."""
    return 4 * (4 * c * (K + 1) + c * vb + K * vb + c * c + K)


def wkv6_cuda(r, k, v, w, u, chunk: int = 64):
    """Launch the kernel: r, k (B, T, H, K) and v (B, T, H, V), all f32 or
    all bf16, contiguous; w (B, T, H, K) and u (H, K), widened to f32.
    ValueError unless ``min(chunk, T)`` divides T.  Returns (B, T, H, V)
    in r's dtype."""
    B, T, H, K = r.shape
    c = kernel_chunk("wkv6", T, chunk)
    if not r.is_cuda:
        raise ValueError("wkv6_cuda needs CUDA tensors")
    if r.dtype not in DENSE_DTYPES:
        raise TypeError(f"r has dtype {r.dtype}, expected one of "
                        f"{tuple(DENSE_DTYPES)}")
    dev = r.device
    w, u = w.float(), u.float()
    for name, t, dt in (("r", r, r.dtype), ("k", k, r.dtype),
                        ("v", v, r.dtype), ("w", w, torch.float32)):
        check_operand(name, t, dt, 4, dev)
    check_operand("u", u, torch.float32, 2, dev)
    V = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape \
            or v.shape[:3] != r.shape[:3] or u.shape != (H, K):
        raise ValueError(f"wkv6 shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)} do not match")
    props = torch.cuda.get_device_properties(dev)
    vb = state_slice(V, B * H, props.multi_processor_count)
    if smem_bytes(K, c, vb) > props.shared_memory_per_block_optin:
        raise ValueError(f"wkv6 kernel: a chunk of {c} with K = {K} needs "
                         f"{smem_bytes(K, c, vb)} bytes of shared memory")
    out = torch.empty((B, T, H, V), dtype=r.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNELS[r.dtype].launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), B, T, H, K, V, c, vb, stream)
    return out
