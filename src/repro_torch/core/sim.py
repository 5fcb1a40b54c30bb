"""Fig-1 reproduction: blocking load/store vs AMU under far-memory latency.

The paper's only quantitative claim (Fig 1 + §1) is qualitative:

  * an OoO core's memory-level parallelism is capped by ROB/IQ/MSHR
    entries, and a long-latency load at ROB head stalls retirement, so
    achieved bandwidth collapses as far-memory latency grows into the
    300 ns – 10 µs band;
  * an asynchronous unit with many outstanding slots and *variable
    granularity* keeps the link saturated across that band.

This module reproduces that claim with a small discrete-event model that
is deliberately faithful to the paper's resource vocabulary (ROB, MSHR,
outstanding slots, granularity), plus closed-form Little's-law bounds so
tests can check the DES against analysis.  It is pure Python/NumPy —
deterministic, seedable, CPU-fast — and a copy of the JAX package's
``repro.core.sim``: the same draws and arithmetic give the same
:class:`SimResult` fields.

Latency distributions model the paper's tiers: local DRAM ~100-200 ns,
disaggregated pool 300 ns – 2 µs, NVM / remote-node tail up to 10 µs.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "LatencyModel",
    "CoreParams",
    "AMUParams",
    "SimResult",
    "simulate_blocking_core",
    "simulate_amu",
    "little_bound_blocking",
    "little_bound_amu",
    "bandwidth_sweep",
]


@dataclass(frozen=True)
class LatencyModel:
    """Far-memory latency distribution (seconds).

    ``kind``: "fixed" | "uniform" | "lognormal" | "bimodal".
    ``lo``/``hi`` bound the support; bimodal mixes (lo, hi) with
    ``tail_frac`` mass at ``hi`` (DRAM pool + slow-NVM-tail scenario).
    """

    kind: str = "fixed"
    lo: float = 200e-9
    hi: float = 200e-9
    tail_frac: float = 0.1

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "fixed":
            return np.full(n, self.lo)
        if self.kind == "uniform":
            return rng.uniform(self.lo, self.hi, n)
        if self.kind == "lognormal":
            mu = math.log(math.sqrt(self.lo * self.hi))
            sigma = math.log(self.hi / self.lo) / 4 if self.hi > self.lo else 0.0
            return np.clip(rng.lognormal(mu, sigma, n), self.lo, self.hi)
        if self.kind == "bimodal":
            tail = rng.random(n) < self.tail_frac
            return np.where(tail, self.hi, self.lo)
        raise ValueError(f"unknown latency kind {self.kind!r}")

    @property
    def mean(self) -> float:
        if self.kind == "fixed":
            return self.lo
        if self.kind == "uniform":
            return 0.5 * (self.lo + self.hi)
        if self.kind == "bimodal":
            return (1 - self.tail_frac) * self.lo + self.tail_frac * self.hi
        # lognormal clipped — close enough to geometric mean for bounds
        return math.sqrt(self.lo * self.hi)


@dataclass(frozen=True)
class CoreParams:
    """Blocking (sync load/store) OoO core — paper Fig 1 left side."""

    rob_entries: int = 256
    mshr_entries: int = 16
    granularity: int = 64          # cache line
    insts_per_access: int = 4      # non-memory work between loads
    cpi: float = 0.25              # cycles/inst at 2 GHz superscalar
    freq_hz: float = 2e9


@dataclass(frozen=True)
class AMUParams:
    """AMU — outstanding-slot count and variable granularity."""

    outstanding: int = 512
    granularity: int = 4096
    issue_overhead: float = 2e-9   # one aload + amortized getfin polling


@dataclass(frozen=True)
class SimResult:
    bytes_moved: int
    elapsed: float
    achieved_bw: float             # bytes/s
    link_bw: float
    utilization: float             # achieved / link
    mean_mlp: float                # time-avg outstanding requests


def _result(bytes_moved: int, elapsed: float, link_bw: float,
            mlp_integral: float) -> SimResult:
    bw = bytes_moved / elapsed if elapsed > 0 else 0.0
    return SimResult(bytes_moved=bytes_moved, elapsed=elapsed,
                     achieved_bw=bw, link_bw=link_bw,
                     utilization=min(1.0, bw / link_bw),
                     mean_mlp=mlp_integral / elapsed if elapsed else 0.0)


def simulate_blocking_core(
    total_bytes: int,
    latency: LatencyModel,
    core: CoreParams = CoreParams(),
    link_bw: float = 50e9,
    seed: int = 0,
) -> SimResult:
    """DES of an OoO core issuing blocking loads over far memory.

    Faithful to the paper's argument, not to any specific µarch:

      * at most ``mshr_entries`` loads in flight,
      * at most ``rob_entries / insts_per_access`` loads in the window
        (in-order retirement: a load at ROB head blocks retirement, so the
        window caps loads between the oldest incomplete and the youngest),
      * issue rate additionally capped by the frontend (cpi · freq),
      * each load moves ``granularity`` bytes; the link serialises bytes
        at ``link_bw`` (so tiny granules also waste the link on latency).
    """
    rng = np.random.default_rng(seed)
    n_req = max(1, total_bytes // core.granularity)
    window = max(1, core.rob_entries // core.insts_per_access)
    mlp_cap = min(core.mshr_entries, window)
    issue_gap = core.insts_per_access * core.cpi / core.freq_hz

    lat = latency.sample(rng, n_req)
    # completion times with in-order retirement: request i may issue only
    # when request i-mlp_cap has *retired* (left the window/MSHR).
    issue_t = np.zeros(n_req)
    done_t = np.zeros(n_req)
    retire_t = np.zeros(n_req)      # in-order: max of own done & predecessor
    link_free = 0.0
    for i in range(n_req):
        t = issue_t[i - 1] + issue_gap if i else 0.0
        if i >= mlp_cap:
            t = max(t, retire_t[i - mlp_cap])
        issue_t[i] = t
        # serialise link occupancy (granularity bytes at link_bw)
        xfer = core.granularity / link_bw
        start_xfer = max(t + lat[i], link_free)
        link_free = start_xfer + xfer
        done_t[i] = start_xfer + xfer
        retire_t[i] = max(done_t[i], retire_t[i - 1] if i else 0.0)
    elapsed = float(retire_t[-1])
    mlp_integral = float(np.sum(done_t - issue_t))
    return _result(n_req * core.granularity, elapsed, link_bw, mlp_integral)


def simulate_amu(
    total_bytes: int,
    latency: LatencyModel,
    amu: AMUParams = AMUParams(),
    link_bw: float = 50e9,
    seed: int = 0,
) -> SimResult:
    """DES of the AMU: ``outstanding`` slots, completion via getfin.

    No in-order retirement — a slot frees the moment its request lands
    (the paper's key structural difference), so long-latency stragglers
    do not block younger requests.
    """
    rng = np.random.default_rng(seed)
    n_req = max(1, total_bytes // amu.granularity)
    lat = latency.sample(rng, n_req)
    slots: List[float] = [0.0] * min(amu.outstanding, n_req)  # free-at times
    heapq.heapify(slots)
    link_free = 0.0
    issue_ready = 0.0
    mlp_integral = 0.0
    last_done = 0.0
    for i in range(n_req):
        slot_free = heapq.heappop(slots)
        t = max(slot_free, issue_ready)
        issue_ready = t + amu.issue_overhead
        xfer = amu.granularity / link_bw
        start_xfer = max(t + lat[i], link_free)
        link_free = start_xfer + xfer
        done = start_xfer + xfer
        heapq.heappush(slots, done)
        mlp_integral += done - t
        last_done = max(last_done, done)
    return _result(n_req * amu.granularity, last_done, link_bw, mlp_integral)


# -- closed-form Little's-law bounds (checked against the DES in tests) ----

def little_bound_blocking(latency_mean: float, core: CoreParams,
                          link_bw: float = 50e9) -> float:
    """Upper bound on blocking-core bandwidth: W·G/(E[L]+G/BW)."""
    window = max(1, core.rob_entries // core.insts_per_access)
    mlp = min(core.mshr_entries, window)
    per_req = latency_mean + core.granularity / link_bw
    return min(link_bw, mlp * core.granularity / per_req)


def little_bound_amu(latency_mean: float, amu: AMUParams,
                     link_bw: float = 50e9) -> float:
    per_req = latency_mean + amu.granularity / link_bw
    issue_cap = amu.granularity / amu.issue_overhead if amu.issue_overhead else link_bw
    return min(link_bw, issue_cap, amu.outstanding * amu.granularity / per_req)


def bandwidth_sweep(
    latencies: Sequence[float],
    total_bytes: int = 1 << 26,
    core: CoreParams = CoreParams(),
    amu: AMUParams = AMUParams(),
    link_bw: float = 50e9,
    kind: str = "fixed",
    seed: int = 0,
) -> List[Dict[str, float]]:
    """The Fig-1 sweep: utilization vs far-memory latency, both designs."""
    rows = []
    for lat in latencies:
        lm = LatencyModel(kind=kind, lo=lat, hi=lat if kind == "fixed" else lat * 10)
        sync = simulate_blocking_core(total_bytes, lm, core, link_bw, seed)
        asyn = simulate_amu(total_bytes, lm, amu, link_bw, seed)
        rows.append({
            "latency_s": lat,
            "sync_util": sync.utilization,
            "amu_util": asyn.utilization,
            "sync_bw": sync.achieved_bw,
            "amu_bw": asyn.achieved_bw,
            "sync_mlp": sync.mean_mlp,
            "amu_mlp": asyn.mean_mlp,
            "speedup": asyn.achieved_bw / max(sync.achieved_bw, 1e-30),
        })
    return rows
