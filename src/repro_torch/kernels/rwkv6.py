"""Chunked RWKV-6 WKV: the CUDA kernel and its plain version.

The CUDA kernel (``csrc/wkv6.cu``) replaces the TPU kernel ``wkv6`` of
``src/repro/kernels/rwkv6.py`` (``_wkv6_kernel``, its ``pallas_call`` at
line 93): the chunked linear recurrence with a K x V f32 state per
(batch row, head).  On the card it is chunk-parallel: the segments'
states from zero, a scan of them, then every piece's outputs, with the
products on the tensor cores; :func:`wkv6_plan` cuts the sequence, and
the source's header gives the design and its bound.  One entry point per
dtype of r, k, v and the output (f32, bf16); w (the log decay) and u (the
bonus) go in as f32, the decay path of the model.  The state crosses
calls: an initial state in, the final state out (both (B, H, K, V) f32),
so a prompt can be served in pieces and a prefill can hand its state to
the one-token step.

:func:`wkv6_torch` is the plain version: the chunked form
:func:`repro_torch.models.ssm.wkv6_chunked`, which is what the
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
                                      recurrence_plan, state_operand)
from repro_torch.kernels.decode_attention import sm_count, smem_optin

__all__ = ["wkv6_torch", "wkv6_cuda", "wkv6_plan", "wkv6_smem", "WIDTHS",
           "KERNELS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: key and value widths K = V with an instance in ``csrc/wkv6.cu``
WIDTHS = (32, 64, 128)
#: entry point per dtype of r, k, v and out
#: (the last two: the initial state in, the final state out, or null)
KERNELS = dense_kernels("wkv6.cu", "wkv6",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P])


def wkv6_torch(r, k, v, w, u, chunk: int = 64,
               initial_state: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """Plain version: r, k, w (B, T, H, K); v (B, T, H, V); u (H, K);
    ``initial_state`` (B, H, K, V) or None (zero).  Returns (B, T, H, V)
    in r's dtype, and with ``return_state`` the final (B, H, K, V) f32
    state too."""
    from repro_torch.models.ssm import wkv6_chunked
    return wkv6_chunked(r, k, v, w, u, chunk=chunk,
                        initial_state=initial_state,
                        return_state=return_state)


def wkv6_smem(K: int, V: int, cp: int, outputs: bool = True) -> int:
    """Shared memory of a block of ``csrc/wkv6.cu`` (its ``Layout``) at
    cp padded rows: k, W (cp + 1 rows) and, with ``outputs``, r at K + 4
    floats a row; v and the state at V + 8; with ``outputs`` att at cp + 4
    and u.  (A block carries its state in shared memory either way.)"""
    n = cp * (K + 4) + (cp + 1) * (K + 4) + cp * (V + 8) + K * (V + 8)
    if outputs:
        n += cp * (K + 4) + cp * (cp + 4) + K
    return 4 * n


@functools.lru_cache(maxsize=256)
def wkv6_plan(B: int, T: int, H: int, K: int, V: int, chunk: int,
              sms: int, smem_limit: int = SMEM_OPTIN,
              rows: Optional[int] = None,
              seg: Optional[int] = None) -> RecurrencePlan:
    """How ``csrc/wkv6.cu`` runs these shapes on ``sms`` SMs
    (:func:`repro_torch.kernels.build.recurrence_plan`): pieces, segments,
    the blocks of its three kernels, the workspace (each segment but the
    last: its K x V state and K log decays, f32) and the shared memory of
    its largest block.  ValueError unless the chunk divides T and K = V is
    a width the source has an instance for (:data:`WIDTHS`)."""
    c = kernel_chunk("wkv6", T, chunk)
    if K not in WIDTHS or V != K:
        raise ValueError(f"wkv6 kernel: K = {K} and V = {V} must be equal "
                         f"and one of {WIDTHS}")
    return recurrence_plan(
        "wkv6", T, c, B * H, sms,
        lambda cp, outputs, update: wkv6_smem(K, V, cp, outputs),
        (K, V, K), lambda rows: (0, 0), smem_limit=smem_limit, rows=rows,
        seg=seg)


def wkv6_cuda(r, k, v, w, u, chunk: int = 64, rows: Optional[int] = None,
              seg: Optional[int] = None,
              initial_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """Launch the kernel: r, k (B, T, H, K) and v (B, T, H, V), all f32 or
    all bf16, contiguous; w (B, T, H, K) and u (H, K), widened to f32;
    ``initial_state`` (B, H, K, V), widened to f32, or None (zero).
    ValueError unless ``min(chunk, T)`` divides T.  ``rows`` / ``seg``
    force the plan's pieces and segments.  Returns (B, T, H, V) in r's
    dtype, and with ``return_state`` the final (B, H, K, V) f32 state,
    which the kernel writes in place of nothing else."""
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
    s_in = state_operand(initial_state, (B, H, K, V), dev)
    plan = wkv6_plan(B, T, H, K, V, c, sm_count(dev), smem_optin(dev),
                     rows=rows, seg=seg)
    out = torch.empty((B, T, H, V), dtype=r.dtype, device=dev)
    s_out = (torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
             if return_state else None)
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNELS[r.dtype].launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(),
            ws.data_ptr() if plan.workspace_bytes else None, B, T, H, K, V,
            plan.rows, plan.seg, stream,
            None if s_in is None else s_in.data_ptr(),
            None if s_out is None else s_out.data_ptr())
    return (out, s_out) if return_state else out
