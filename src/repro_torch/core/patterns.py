"""Access Pattern Register contents (paper §2.2).

The paper's AMU can be programmed with *complex access patterns* (stride,
stream, ...) so one instruction moves a whole structured region, split
into granules (requests) of a configurable size.  The JAX package's
``core/patterns.py`` keeps that vocabulary; the port has the part its
callers use — the contiguous stream and the granule count the
quickstart prints — copied unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

__all__ = ["AccessPattern", "StreamPattern", "granules"]


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


def granules(pattern: AccessPattern, granularity: int) -> int:
    """Number of requests the AMU issues for ``pattern`` at ``granularity``."""
    return sum(1 for _ in pattern.granule_ranges(granularity))
