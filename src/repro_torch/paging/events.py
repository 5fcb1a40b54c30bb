"""Event-driven serving scheduler (the paper's §2.3.2 model, generalized).

The paper's event-driven programming model drives computation from
memory-completion events: issue many asynchronous accesses, then let
``getfin`` completions — not program order — decide what runs next.
Here the same loop shape schedules *sequences* instead of cache lines:

  * ``TICK`` — one decode step of the serving engine (the compute event
    the paper overlaps transfers against),
  * ``PAGE_ARRIVED`` — a pager ``getfin`` completion flipped a page's
    residency bit; a waiting sequence may now be runnable,
  * ``ADMIT`` / ``PREEMPT`` — capacity decisions made from *free-page
    watermarks* over the device pool, replacing the seed engine's
    free-slot counting: a request is admitted when the pool can hold
    its working set above the low watermark, and a victim is preempted
    when free pages fall below it,
  * ``COMPLETE`` — a sequence finished and released its pages.

The loop itself is deliberately tiny and deterministic: a FIFO event
queue drained to empty each iteration, with handlers registered per
event kind.  Both the serving engine (`repro_torch.serve.engine`) and the
``paged_kv_sweep`` benchmark drive their scheduling through it.
"""

from __future__ import annotations

import collections
import enum
import heapq
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Tuple

from repro_torch.obs import MetricsRegistry
from repro_torch.paging.page_table import PagePool, PagingError

__all__ = ["EventKind", "Event", "EventLoop", "WatermarkPolicy",
           "DeadlineQueue"]


class EventKind(enum.Enum):
    TICK = "tick"                    # one decode step elapsed
    PAGE_ARRIVED = "page_arrived"    # getfin landed a page (seq, logical)
    ADMIT = "admit"                  # admission decision for a request
    PREEMPT = "preempt"              # a victim must shed pages
    COMPLETE = "complete"            # a sequence finished
    DEADLINE = "deadline"            # a request's SLO deadline passed
    HANDOFF = "handoff"              # prefill graduated a request to the
                                     # shared far tier (disaggregation)


@dataclass
class Event:
    kind: EventKind
    payload: Any = None


@dataclass
class WatermarkPolicy:
    """Free-page watermark admission/preemption rules.

    low
        Frames that must remain free *after* an admission for it to be
        allowed — headroom so active sequences can still grow a page
        without an immediate preemption storm.
    critical
        When free frames fall to/below this, the scheduler should start
        preempting (shedding cold pages) even between admissions.

    The free-SPM-slot counting of the paper's event-driven scheduler
    (§2.3.2) generalized to a two-threshold policy.  Example::

        policy = WatermarkPolicy(low=2, critical=0)
        policy.can_admit(pool, pages_needed=4)   # free - 4 >= 2 ?
        policy.deficit(pool, 4)                  # frames to shed first
    """

    low: int = 1
    critical: int = 0

    def can_admit(self, pool: PagePool, pages_needed: int) -> bool:
        return pool.n_free - pages_needed >= self.low

    def should_preempt(self, pool: PagePool) -> bool:
        return pool.n_free <= self.critical

    def deficit(self, pool: PagePool, pages_needed: int) -> int:
        """Frames that must be freed before ``pages_needed`` fits."""
        return max(0, pages_needed + self.low - pool.n_free)


class DeadlineQueue:
    """Min-heap of (time, payload) deadlines on the engine's virtual
    clock.  Each tick the SLO scheduler pops everything due and posts a
    ``DEADLINE`` event per entry — the timer half of the event-driven
    model (§2.3.2), where passing time (a blown TTFT deadline) is as
    much a scheduling event as an arriving page.

    Example::

        dq = DeadlineQueue()
        dq.schedule(0.050, rid)            # TTFT deadline at t=50ms
        for t, rid in dq.pop_due(clock()):
            loop.post(EventKind.DEADLINE, (t, rid))
    """

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = itertools.count()      # FIFO among equal deadlines

    def schedule(self, t: float, payload: Any = None) -> None:
        heapq.heappush(self._heap, (float(t), next(self._seq), payload))

    def pop_due(self, now: float) -> List[Tuple[float, Any]]:
        """All (deadline, payload) entries with deadline <= ``now``."""
        due: List[Tuple[float, Any]] = []
        while self._heap and self._heap[0][0] <= now:
            t, _, payload = heapq.heappop(self._heap)
            due.append((t, payload))
        return due

    def peek(self) -> float:
        """Earliest scheduled deadline (inf when empty)."""
        return self._heap[0][0] if self._heap else float("inf")

    def __len__(self) -> int:
        return len(self._heap)


class EventLoop:
    """FIFO event queue with per-kind handlers, drained to quiescence —
    the paper's §2.3.2 event-driven model as a scheduler skeleton.

    Example (the engine's wiring)::

        loop = EventLoop()
        loop.on(EventKind.PAGE_ARRIVED, lambda ev: land(ev.payload))
        loop.post(EventKind.PAGE_ARRIVED, (rid, logical))
        loop.tick()        # one decode step: post TICK + drain all
    """

    def __init__(self, metrics: "MetricsRegistry" = None) -> None:
        self._q: Deque[Event] = collections.deque()
        self._handlers: Dict[EventKind, List[Callable[[Event], None]]] = \
            collections.defaultdict(list)
        self.ticks = 0
        # Counter-compatible view onto a shared MetricsRegistry, keyed
        # by EventKind (history[EventKind.PREEMPT] etc. work unchanged)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.history = self.metrics.counters("events")

    def on(self, kind: EventKind, handler: Callable[[Event], None]) -> None:
        self._handlers[kind].append(handler)

    def post(self, kind: EventKind, payload: Any = None) -> None:
        self._q.append(Event(kind, payload))

    def tick(self) -> None:
        """Post one TICK and drain — the per-decode-step heartbeat."""
        self.ticks += 1
        self.post(EventKind.TICK, self.ticks)
        self.drain()

    def drain(self, max_events: int = 100_000) -> int:
        """Dispatch queued events (and any they post) until quiescent."""
        n = 0
        while self._q:
            if n >= max_events:
                raise PagingError("event loop livelock: "
                                  f"{max_events} events without quiescing")
            ev = self._q.popleft()
            self.history[ev.kind] += 1
            for h in self._handlers.get(ev.kind, ()):
                h(ev)
            n += 1
        return n

    @property
    def pending(self) -> int:
        return len(self._q)
