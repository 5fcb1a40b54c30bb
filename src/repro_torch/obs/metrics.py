"""MetricsRegistry: counters, gauges, and log-bucketed histograms.

The paper's premise is that far-memory latency is *widely distributed*
and the AMU's job is hiding that distribution — which means the signals
that matter are distributions and tails (p95/p99), not means.  Before
this module every subsystem kept its own flat ``collections.Counter``
(``pager.stats``, ``engine.stats``, ``events.history``); those now live
as :class:`CounterView` windows onto one shared :class:`MetricsRegistry`
so a single flat-metrics export sees everything, while every existing
``stats["key"]`` / ``dict(stats)`` call site keeps working unchanged.

Histograms are log-bucketed: bucket ``i`` covers
``(floor * growth**(i-1), floor * growth**i]``, so memory is O(decades)
regardless of sample count and any percentile is reproducible to a
relative error of about ``growth - 1`` (the default 1.05 ⇒ ≤ ~5%,
checked against a numpy reference in ``tests/test_obs.py``).  ``min`` /
``max`` / ``sum`` / ``count`` are tracked exactly, so ``max`` — the
operative tail statistic — has no bucketing error.
"""

from __future__ import annotations

import math
from collections.abc import MutableMapping
from typing import Any, Dict, Optional

__all__ = ["CounterView", "Histogram", "MetricsRegistry"]


class CounterView(MutableMapping):
    """A ``collections.Counter``-compatible view over one registry group.

    Missing keys read as 0 (Counter semantics) but are not created;
    ``view[k] += 1`` works; keys may be any hashable (the event loop's
    history is keyed by :class:`~repro_torch.paging.events.EventKind`).  The
    underlying dict is owned by the registry, so every increment lands
    in the shared export without the call site knowing the registry
    exists.
    """

    __slots__ = ("_data",)

    def __init__(self, data: Dict[Any, float]) -> None:
        self._data = data

    def __getitem__(self, key):
        return self._data.get(key, 0)

    def __setitem__(self, key, value):
        self._data[key] = value

    def __delitem__(self, key):
        del self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def get(self, key, default=0):
        return self._data.get(key, default)

    def __eq__(self, other):
        if isinstance(other, CounterView):
            return self._data == other._data
        if isinstance(other, dict):
            return self._data == dict(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self):
        return f"CounterView({self._data!r})"


class Histogram:
    """Log-bucketed latency histogram with exact min/max/sum/count.

    ``observe`` is allocation-free on the hot path (one dict upsert);
    percentiles walk the sparse bucket dict only when asked.
    """

    __slots__ = ("name", "growth", "floor", "_log_g", "count", "total",
                 "vmin", "vmax", "buckets")

    def __init__(self, name: str = "", growth: float = 1.05,
                 floor: float = 1e-9) -> None:
        if growth <= 1.0:
            raise ValueError("histogram growth factor must be > 1")
        self.name = name
        self.growth = float(growth)
        self.floor = float(floor)
        self._log_g = math.log(self.growth)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= self.floor:
            idx = 0
        else:
            idx = 1 + int(math.log(v / self.floor) / self._log_g)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def _bucket_value(self, idx: int) -> float:
        if idx <= 0:
            val = self.floor
        else:
            # geometric midpoint of (floor*g^(i-1), floor*g^i]
            val = self.floor * math.exp(self._log_g * (idx - 0.5))
        return min(max(val, self.vmin), self.vmax)

    def percentile(self, q: float) -> float:
        """Approximate ``numpy.percentile(samples, q)``: the value of the
        bucket containing the linear-interpolation rank, clamped to the
        exact observed min/max."""
        if self.count == 0:
            return 0.0
        rank = (q / 100.0) * (self.count - 1)
        if rank >= self.count - 1:
            return self.vmax          # the tail stat is exact, not bucketed
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen - 1 >= rank:
                return self._bucket_value(idx)
        return self.vmax

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def max(self) -> float:
        return self.vmax if self.count else 0.0

    @property
    def min(self) -> float:
        return self.vmin if self.count else 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min, "max": self.max, "p50": self.p50,
                "p95": self.p95, "p99": self.p99}

    def __repr__(self):
        return (f"Histogram({self.name!r}, n={self.count}, "
                f"p50={self.p50:.3g}, p99={self.p99:.3g}, "
                f"max={self.max:.3g})")


def _export_key(key: Any) -> str:
    """Flatten a counter key for JSON export (EventKind → its name)."""
    if isinstance(key, str):
        return key
    return getattr(key, "name", None) or str(key)


class MetricsRegistry:
    """One process-wide sink for counters, gauges, and histograms.

    Subsystems request a named counter *group*
    (``registry.counters("pager")``) and get back a dict-compatible
    :class:`CounterView`; histograms and gauges are keyed by flat
    slash-separated names (``amu/latency_s/aload/LATENCY``).
    :meth:`snapshot` renders everything as one JSON-safe dict — the
    payload behind ``--metrics-out``.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Dict[Any, float]] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counters(self, group: str,
                 initial: Optional[Dict[Any, float]] = None) -> CounterView:
        data = self._counters.setdefault(group, {})
        if initial:
            for k, v in initial.items():
                data.setdefault(k, v)
        return CounterView(data)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def histogram(self, name: str, *, growth: float = 1.05,
                  floor: float = 1e-9) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, growth, floor)
        return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {
                group: {_export_key(k): v for k, v in data.items()}
                for group, data in self._counters.items()},
            "gauges": dict(self.gauges),
            "histograms": {name: h.snapshot()
                           for name, h in self.histograms.items()},
        }
