"""Access Pattern Register contents (paper §2.2).

The paper's AMU can be programmed with *complex access patterns* (stride,
stream, ...) so one instruction moves a whole structured region.  The
port keeps the JAX package's vocabulary (``core/patterns.py``), copied
unchanged:

  * the runtime AMU splits a pattern into granules (requests),
  * the SPM planner sizes prefetch buffers from the pattern's reuse,
  * kernels pick their schedule from the pattern kind — the gather
    kernel (``kernels/moe_gather.py``) copies rows one by one and leaves
    coalescing of semi-sorted indices to :class:`GatherPattern`.

Patterns are plain frozen dataclasses, so they hash and can live in
configs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Sequence, Tuple

__all__ = [
    "AccessPattern",
    "StreamPattern",
    "StridePattern",
    "GatherPattern",
    "ScatterPattern",
    "granules",
    "coalescing_ratio",
]


@dataclass(frozen=True)
class AccessPattern:
    """Base descriptor: a logical region of ``total_bytes``."""

    total_bytes: int

    def granule_ranges(self, granularity: int) -> Iterator[Tuple[int, int]]:
        """Yield (offset, nbytes) granules covering the pattern."""
        raise NotImplementedError


@dataclass(frozen=True)
class StreamPattern(AccessPattern):
    """Contiguous stream — the double-buffered pipeline case."""

    def granule_ranges(self, granularity: int) -> Iterator[Tuple[int, int]]:
        off = 0
        while off < self.total_bytes:
            yield off, min(granularity, self.total_bytes - off)
            off += granularity


@dataclass(frozen=True)
class StridePattern(AccessPattern):
    """``count`` blocks of ``block_bytes`` separated by ``stride_bytes``."""

    block_bytes: int = 0
    stride_bytes: int = 0
    count: int = 0

    def __post_init__(self):
        if self.block_bytes > self.stride_bytes > 0:
            raise ValueError("block_bytes must not exceed stride_bytes")

    def granule_ranges(self, granularity: int) -> Iterator[Tuple[int, int]]:
        for i in range(self.count):
            base = i * self.stride_bytes
            off = 0
            while off < self.block_bytes:
                yield base + off, min(granularity, self.block_bytes - off)
                off += granularity


@dataclass(frozen=True)
class GatherPattern(AccessPattern):
    """Indexed reads (MoE expert dispatch, paged-KV fetch).

    ``indices`` are element offsets of ``elem_bytes`` each; contiguous runs
    are coalesced into one granule up to ``granularity`` — the AMU's
    variable-granularity win for semi-sorted gathers.
    """

    indices: Tuple[int, ...] = field(default_factory=tuple)
    elem_bytes: int = 1

    def granule_ranges(self, granularity: int) -> Iterator[Tuple[int, int]]:
        if not self.indices:
            return
        run_start = prev = self.indices[0]
        run_len = 1
        for ix in self.indices[1:]:
            contiguous = ix == prev + 1
            if contiguous and (run_len + 1) * self.elem_bytes <= granularity:
                run_len += 1
            else:
                yield run_start * self.elem_bytes, run_len * self.elem_bytes
                run_start, run_len = ix, 1
            prev = ix
        yield run_start * self.elem_bytes, run_len * self.elem_bytes


@dataclass(frozen=True)
class ScatterPattern(GatherPattern):
    """Indexed writes — same coalescing as GatherPattern."""


def granules(pattern: AccessPattern, granularity: int) -> int:
    """Number of requests the AMU issues for ``pattern`` at ``granularity``."""
    return sum(1 for _ in pattern.granule_ranges(granularity))


def coalescing_ratio(indices: Sequence[int], elem_bytes: int,
                     granularity: int) -> float:
    """requests(naive one-per-element) / requests(coalesced).

    >1 means the AMU's variable granularity reduced request count — the
    paper's aggregated-bandwidth argument in one number.
    """
    idx = tuple(int(i) for i in indices)
    if not idx:
        return 1.0
    pat = GatherPattern(total_bytes=len(idx) * elem_bytes, indices=idx,
                        elem_bytes=elem_bytes)
    return len(idx) / max(1, granules(pat, granularity))
