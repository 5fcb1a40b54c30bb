"""Serving-side slot bookkeeping: the fixed decode slots of the engine.

The engine's device cache is the paged
:class:`~repro_torch.models.model.PagedCache` (pool frames + page
tables); the KV never leaves its frames, so of the JAX package's
``serve/kv_cache.py`` only :class:`SlotPool` is needed here.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

from repro_torch.core.amu import AMUError

__all__ = ["SlotPool"]


class SlotPool:
    """Fixed decode slots.  The free list is a min-heap so alloc/release
    are O(log n) and ids hand out lowest-first.

    Example::

        pool = SlotPool(4)
        slot = pool.alloc()        # -> 0 (lowest first)
        pool.release(slot)
        pool.release(slot)         # raises AMUError (double release)
    """

    def __init__(self, n_slots: int):
        self.free: List[int] = list(range(n_slots))
        heapq.heapify(self.free)
        self._is_free = [True] * n_slots
        self.n_slots = n_slots

    def alloc(self) -> Optional[int]:
        if not self.free:
            return None
        slot = heapq.heappop(self.free)
        self._is_free[slot] = False
        return slot

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise AMUError(f"release of invalid slot {slot} "
                           f"(pool has {self.n_slots})")
        if self._is_free[slot]:
            raise AMUError(f"double release of slot {slot}")
        self._is_free[slot] = True
        heapq.heappush(self.free, slot)

    @property
    def n_free(self) -> int:
        return len(self.free)
