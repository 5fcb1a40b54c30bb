"""Exporters: Chrome-trace/Perfetto JSON timeline + flat metrics JSON.

:func:`to_chrome_trace` renders a :class:`~repro_torch.obs.tracer.Tracer`'s
event list in the Chrome trace-event JSON format that Perfetto
(https://ui.perfetto.dev) loads directly:

  * each ``(pid, tid)`` track pair becomes a named process/thread via
    ``"M"`` metadata events,
  * spans are ``"X"`` complete events (``ts``/``dur`` in microseconds of
    *virtual* time — the shared engine clock),
  * instants are ``"i"`` (scope ``"t"``), counter samples are ``"C"``
    (one Perfetto area chart per counter name — the per-QoS
    window-occupancy tracks),
  * AMU transfer spans overlap heavily by design (that is the paper's
    whole point), and overlapping ``"X"`` events on one thread are not
    legal Chrome-trace nesting — so the exporter lane-packs each AMU
    track greedily into ``LATENCY``, ``LATENCY·2``, … sub-lanes, which
    doubles as a visual in-flight-depth readout.

Spans still open at export (requests alive when the run stopped) are
flushed closed at the current clock and tagged ``incomplete``.
"""

from __future__ import annotations

import heapq
import json
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry
from .tracer import Tracer

__all__ = ["to_chrome_trace", "write_chrome_trace", "write_metrics"]

#: process names whose span tracks are lane-packed (overlap-by-design)
_PACKED_PIDS = frozenset({"amu"})


def _json_args(args: Optional[dict]) -> Dict[str, Any]:
    if not args:
        return {}
    out = {}
    for k, v in args.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = str(v)
    return out


def _pack_lanes(spans: List[dict]) -> None:
    """Greedy interval-graph colouring: assign each overlapping span the
    lowest free lane; mutates each span dict with a ``_lane`` key."""
    free: List[int] = []         # released lane numbers (min-heap)
    busy: List[tuple] = []       # (end_ts, lane) min-heap
    n_lanes = 0
    for sp in sorted(spans, key=lambda s: (s["ts"], -s["dur"])):
        t0 = sp["ts"]
        while busy and busy[0][0] <= t0:
            _, lane = heapq.heappop(busy)
            heapq.heappush(free, lane)
        if free:
            lane = heapq.heappop(free)
        else:
            lane = n_lanes
            n_lanes += 1
        sp["_lane"] = lane
        heapq.heappush(busy, (t0 + sp["dur"], lane))


def to_chrome_trace(tracer: Tracer,
                    metrics: Optional[MetricsRegistry] = None) -> dict:
    """Render the tracer's events as a Chrome-trace JSON dict."""
    n_open = tracer.flush_open({"incomplete": True})

    raw = []
    for ph, pid, tid, name, ts, dv, args in tracer.events:
        ev = {"ph": ph, "pid": pid, "tid": tid, "name": name,
              "ts": ts * 1e6}
        if ph == "X":
            ev["dur"] = dv * 1e6
            ev["args"] = _json_args(args)
        elif ph == "i":
            ev["s"] = "t"
            ev["args"] = _json_args(args)
        else:  # "C"
            ev["args"] = {"value": dv}
        raw.append(ev)

    # lane-pack overlapping span tracks (AMU transfers)
    by_track: Dict[tuple, List[dict]] = {}
    for ev in raw:
        if ev["ph"] == "X" and ev["pid"] in _PACKED_PIDS:
            by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for (pid, tid), spans in by_track.items():
        _pack_lanes(spans)
        for sp in spans:
            lane = sp.pop("_lane")
            if lane:
                sp["tid"] = f"{tid}·{lane + 1}"

    # map string pid/tid -> stable ints + metadata name events
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[dict] = []
    for ev in raw:
        pname, tname = ev["pid"], ev["tid"]
        if pname not in pids:
            pids[pname] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[pname], "tid": 0,
                           "args": {"name": pname}})
        pid = pids[pname]
        key = (pname, tname)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": tname}})
        ev["pid"] = pid
        ev["tid"] = tids[key]
        events.append(ev)

    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro_torch.obs",
            "clock": "virtual",
            "clock_s": tracer.clock(),
            "open_spans_flushed": n_open,
        },
    }
    if metrics is not None:
        doc["otherData"]["metrics"] = metrics.snapshot()
    return doc


def write_chrome_trace(path: str, tracer: Tracer,
                       metrics: Optional[MetricsRegistry] = None) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, metrics), f)


def write_metrics(path: str, metrics: MetricsRegistry) -> None:
    with open(path, "w") as f:
        json.dump(metrics.snapshot(), f, indent=2, sort_keys=True)
