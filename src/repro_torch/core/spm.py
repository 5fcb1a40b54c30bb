"""SPM planner — the paper's reconfigurable Cache/SPM split, for VMEM.

The paper lets applications carve part of the cache into scratch-pad memory
and size it per workload.  On TPU all of VMEM is software-managed, so the
*knob that survives* is how a kernel splits its VMEM budget between

  * working tiles (the "cache" share — data being computed on now), and
  * prefetch buffers (the "SPM" share — tiles in flight via async DMA).

:class:`SPMPlan` turns (VMEM budget, tile byte-sizes, desired pipeline
depth) into concrete block shapes + buffer counts that kernels and the
dry-run use.  It is deliberately analytical — the same arithmetic a kernel
author does on a napkin — so tests can assert its invariants.

This is the JAX package's planner, copied unchanged (``VMEM_BYTES`` and
every default included), so it gives the same plans for the same
arguments.  On Hopper the SPM is a block's shared memory, and the split
between L1 and shared memory is the reconfigurable cache/SPM split: the
CUDA wrapper of :mod:`repro_torch.kernels.amu_matmul` plans against the
card's opt-in shared memory per block, passed as ``vmem_budget``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

__all__ = ["VMEM_BYTES", "SPMPlan", "plan_matmul_blocks", "plan_attention_blocks"]

#: v5e VMEM per core (128 MiB); kernels plan against a safety margin.
VMEM_BYTES: int = 128 * 1024 * 1024
_SAFETY = 0.8

#: MXU/VPU-aligned tiling: last dim multiples of 128, second-to-last of 8.
LANE = 128
SUBLANE = 8


def _round_down(x: int, m: int) -> int:
    return max(m, (x // m) * m)


@dataclass(frozen=True)
class SPMPlan:
    """A concrete VMEM split for one kernel invocation."""

    block_shapes: Dict[str, Tuple[int, ...]]
    buffers: Dict[str, int]          # #copies per operand (2 = double buffer)
    vmem_bytes: int                  # total planned footprint
    pipeline_depth: int              # outstanding DMA per operand

    def __post_init__(self):
        if self.vmem_bytes > VMEM_BYTES:
            raise ValueError(
                f"SPM plan exceeds VMEM: {self.vmem_bytes} > {VMEM_BYTES}")

    @property
    def utilization(self) -> float:
        return self.vmem_bytes / VMEM_BYTES


def _bytes_of(shape: Sequence[int], dtype_bytes: int) -> int:
    return int(math.prod(shape)) * dtype_bytes


def plan_matmul_blocks(
    m: int, k: int, n: int,
    dtype_bytes: int = 2,
    acc_bytes: int = 4,
    pipeline_depth: int = 2,
    vmem_budget: int = int(VMEM_BYTES * _SAFETY),
) -> SPMPlan:
    """Pick (bm, bk, bn) for an AMU-pipelined matmul.

    Footprint = depth·(bm·bk + bk·bn)·dtype + bm·bn·acc.  We prefer large
    bn/bk (MXU likes 128-multiples on the contracting/lane dims), then grow
    bm while the budget holds.
    """
    bm = _round_down(min(m, 512), SUBLANE)
    bk = _round_down(min(k, 512), LANE)
    bn = _round_down(min(n, 1024), LANE)

    def footprint(bm, bk, bn):
        return (pipeline_depth * (_bytes_of((bm, bk), dtype_bytes)
                                  + _bytes_of((bk, bn), dtype_bytes))
                + _bytes_of((bm, bn), acc_bytes))

    # shrink until it fits, preferring to keep lane dims large
    for dim in ("bm", "bk", "bn", "bm", "bk", "bn", "bm"):
        if footprint(bm, bk, bn) <= vmem_budget:
            break
        if dim == "bm" and bm > SUBLANE:
            bm = _round_down(bm // 2, SUBLANE)
        elif dim == "bk" and bk > LANE:
            bk = _round_down(bk // 2, LANE)
        elif dim == "bn" and bn > LANE:
            bn = _round_down(bn // 2, LANE)
    fp = footprint(bm, bk, bn)
    if fp > vmem_budget:
        raise ValueError(f"cannot fit matmul tiles in VMEM budget ({fp}B)")
    return SPMPlan(
        block_shapes={"x": (bm, bk), "w": (bk, bn), "out": (bm, bn)},
        buffers={"x": pipeline_depth, "w": pipeline_depth, "out": 1},
        vmem_bytes=fp,
        pipeline_depth=pipeline_depth,
    )


def plan_attention_blocks(
    q_len: int, kv_len: int, head_dim: int,
    dtype_bytes: int = 2,
    pipeline_depth: int = 2,
    vmem_budget: int = int(VMEM_BYTES * _SAFETY),
) -> SPMPlan:
    """Pick (block_q, block_kv) for streaming flash attention.

    K/V stream through SPM (the AMU stream pattern); Q and the softmax
    state are the resident working set.
    """
    block_q = _round_down(min(q_len, 512), SUBLANE)
    block_kv = _round_down(min(kv_len, 1024), LANE)
    hd = max(head_dim, LANE)

    def footprint(bq, bkv):
        q = _bytes_of((bq, hd), dtype_bytes)
        kv = 2 * pipeline_depth * _bytes_of((bkv, hd), dtype_bytes)
        acc = _bytes_of((bq, hd), 4) + 2 * _bytes_of((bq, LANE), 4)
        s = _bytes_of((bq, bkv), 4)
        return q + kv + acc + s

    while footprint(block_q, block_kv) > vmem_budget:
        if block_kv > LANE:
            block_kv = _round_down(block_kv // 2, LANE)
        elif block_q > SUBLANE:
            block_q = _round_down(block_q // 2, SUBLANE)
        else:
            raise ValueError("cannot fit attention tiles in VMEM budget")
    return SPMPlan(
        block_shapes={"q": (block_q, hd), "kv": (block_kv, hd)},
        buffers={"q": 1, "k": pipeline_depth, "v": pipeline_depth},
        vmem_bytes=footprint(block_q, block_kv),
        pipeline_depth=pipeline_depth,
    )
