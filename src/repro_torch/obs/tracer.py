"""Tracer: structured spans/instants/counter samples on one clock.

Every event carries a ``(pid, tid)`` track pair — process/thread names
in the Chrome-trace sense — and a timestamp from the *injected* clock,
which in this repo is the engine's single :class:`VirtualClock` (the
pager's simulated AMU backend advances in lockstep), so AMU transfer
spans, pager actions, and request lifecycle spans all land on one
shared, deterministic time axis.

Design constraints from the issue:

  * **default-off-cheap** — every method starts with one attribute test
    (``if not self.enabled: return``); hot call sites additionally guard
    with ``if tracer.enabled:`` before building an args dict, so a
    disabled tracer costs one branch and zero allocations,
  * **allocation-light when on** — events are plain tuples appended to
    one list; no per-event objects, no string formatting until export,
  * **well-formed spans** — ``begin`` returns a span id tracked in
    ``open_spans`` until ``end`` pops it, so tests (and the exporter)
    can assert every open span closes.

Event tuple layout: ``(ph, pid, tid, name, ts, dur_or_value, args)``
with ``ph`` one of ``"X"`` (complete span), ``"i"`` (instant), ``"C"``
(counter sample).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Tracer", "NULL_TRACER"]

Event = Tuple[str, str, str, str, float, float, Optional[dict]]


def _zero_clock() -> float:
    return 0.0


class Tracer:
    __slots__ = ("enabled", "clock", "events", "open_spans", "_next_sid",
                 "_append", "_last_counter")

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self.clock = clock if clock is not None else _zero_clock
        self.events: List[Event] = []
        # bound once: the hot emission paths run per simulated transfer,
        # so one attribute lookup per event is worth saving
        self._append = self.events.append
        #: (pid, name) -> last emitted counter value, for sample dedup
        self._last_counter: Dict[Tuple[str, str], float] = {}
        #: sid -> (pid, tid, name, t0, args) for spans begun but not ended
        self.open_spans: Dict[int, Tuple[str, str, str, float,
                                         Optional[dict]]] = {}
        self._next_sid = 1

    # -- emission -------------------------------------------------------------

    def instant(self, pid: str, tid: str, name: str,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._append(("i", pid, tid, name, self.clock(), 0.0, args))

    def counter(self, pid: str, name: str, value: float) -> None:
        """One sample of a counter track (e.g. per-QoS window occupancy);
        rendered as a stepped area chart in Perfetto.  Samples equal to
        the track's previous value are dropped — a stepped chart renders
        identically, and periodic samplers (the pager polls
        ``free_frames`` every tick) stop flooding the trace."""
        if not self.enabled:
            return
        v = float(value)
        key = (pid, name)
        if self._last_counter.get(key) == v:
            return
        self._last_counter[key] = v
        self._append(("C", pid, name, name, self.clock(), v, None))

    def begin(self, pid: str, tid: str, name: str,
              args: Optional[dict] = None) -> int:
        """Open a span at ``clock()``; returns a span id for :meth:`end`
        (0 when disabled — ``end(0)`` is a no-op, so call sites need no
        branch)."""
        if not self.enabled:
            return 0
        sid = self._next_sid
        self._next_sid = sid + 1
        self.open_spans[sid] = (pid, tid, name, self.clock(), args)
        return sid

    def end(self, sid: int, args: Optional[dict] = None) -> None:
        if not sid:
            return
        ent = self.open_spans.pop(sid, None)
        if ent is None:
            return
        pid, tid, name, t0, a0 = ent
        if args:
            a0 = {**a0, **args} if a0 else dict(args)
        self._append(("X", pid, tid, name, t0,
                      max(0.0, self.clock() - t0), a0))

    def complete(self, pid: str, tid: str, name: str, t0: float,
                 t1: Optional[float] = None,
                 args: Optional[dict] = None) -> None:
        """Record a span whose start time is already known (e.g. an AMU
        request's ``issue_t`` at retire time) without open-span tracking."""
        if not self.enabled:
            return
        if t1 is None:
            t1 = self.clock()
        self._append(("X", pid, tid, name, t0,
                      max(0.0, t1 - t0), args))

    def flush_open(self, args: Optional[dict] = None) -> int:
        """Close any spans still open (e.g. requests in flight when the
        run stops); returns how many were force-closed."""
        dangling = list(self.open_spans)
        for sid in dangling:
            self.end(sid, args)
        return len(dangling)


#: Shared disabled tracer: instrumented code holds a tracer attribute
#: unconditionally and pays one `enabled` branch when telemetry is off.
NULL_TRACER = Tracer(enabled=False)
