"""The port's simulators against the JAX package's, on the CPU.

``repro_torch.core.sim`` (the Fig-1 discrete-event model) must give the
reference's ``SimResult`` fields, sweep rows and Little bounds exactly,
and hold the paper's claims that ``tests/test_sim.py`` asserts of the
reference.  Every ``repro_torch.paging.sim`` entry point but
``simulate_spec_decode`` must return the reference's dict, key for key
and float for float, at a point of its ``benchmarks/run.py`` sweep: it
is the same arithmetic on the port's paging stack.  The reference's
``simulate_spec_decode`` seeds ``random.Random`` with a tuple, which
this Python refuses, so the port's is held to itself: equal across
calls and across processes with different hash seeds, its counters
balanced.  ``repro_torch.launch.far_memory_stream`` must print the
reference example's times.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import sim as jsim
from repro.paging import sim as jpsim
from repro_torch.core import sim as tsim
from repro_torch.launch import far_memory_stream
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.paging import sim as tpsim

ROOT = Path(__file__).resolve().parents[1]
LINK = 50e9
MB = 1 << 22


# ---------------------------------------------------------------------------
# core/sim.py
# ---------------------------------------------------------------------------

LATENCIES = [
    ("fixed", 200e-9, 200e-9, 0.1),
    ("uniform", 300e-9, 3e-6, 0.1),
    ("lognormal", 1e-6, 1e-5, 0.1),
    ("bimodal", 300e-9, 10e-6, 0.2),
]


@pytest.mark.parametrize("kind,lo,hi,tail", LATENCIES)
def test_simulators_match_reference(kind, lo, hi, tail):
    """Every ``SimResult`` field of both designs, over granularities,
    windows and seeds, and each latency model's mean."""
    tl = tsim.LatencyModel(kind, lo, hi, tail)
    jl = jsim.LatencyModel(kind, lo, hi, tail)
    assert tl.mean == jl.mean
    for seed, gran, window in ((0, 64, 16), (3, 256, 64)):
        core = dict(mshr_entries=window, granularity=gran)
        t = tsim.simulate_blocking_core(MB >> 2, tl, tsim.CoreParams(**core),
                                        LINK, seed)
        j = jsim.simulate_blocking_core(MB >> 2, jl, jsim.CoreParams(**core),
                                        LINK, seed)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        amu = dict(outstanding=window * 8, granularity=gran * 16)
        t = tsim.simulate_amu(MB, tl, tsim.AMUParams(**amu), LINK, seed)
        j = jsim.simulate_amu(MB, jl, jsim.AMUParams(**amu), LINK, seed)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("kind", ["fixed", "uniform"])
def test_bandwidth_sweep_and_little_bounds_match_reference(kind):
    """``bench_fig1_latency_sweep``'s latencies (``benchmarks/run.py:92``)
    at 4 MiB, and both Little bounds at each."""
    lats = [100e-9, 300e-9, 1e-6, 10e-6]
    assert tsim.bandwidth_sweep(lats, total_bytes=MB, kind=kind) == \
        jsim.bandwidth_sweep(lats, total_bytes=MB, kind=kind)
    for lat in lats:
        assert tsim.little_bound_blocking(lat, tsim.CoreParams(), LINK) == \
            jsim.little_bound_blocking(lat, jsim.CoreParams(), LINK)
        assert tsim.little_bound_amu(lat, tsim.AMUParams(), LINK) == \
            jsim.little_bound_amu(lat, jsim.AMUParams(), LINK)


def test_bad_latency_kind_raises():
    import numpy as np
    with pytest.raises(ValueError):
        tsim.LatencyModel("pareto").sample(np.random.default_rng(0), 4)


def _sync_collapses(m):
    rows = m.bandwidth_sweep([200e-9, 1e-6, 3e-6, 10e-6], total_bytes=MB)
    utils = [r["sync_util"] for r in rows]
    assert all(a > b for a, b in zip(utils, utils[1:])), utils
    assert utils[-1] < 0.01


def _amu_sustains(m):
    rows = m.bandwidth_sweep([200e-9, 1e-6, 3e-6, 10e-6], total_bytes=MB)
    assert all(r["amu_util"] > 0.85 for r in rows), rows
    assert all(r["speedup"] > 5 for r in rows)


def _speedup_grows(m):
    rows = m.bandwidth_sweep([200e-9, 1e-6, 10e-6], total_bytes=MB)
    sp = [r["speedup"] for r in rows]
    assert sp[0] < sp[1] < sp[2]


def _granularity(m):
    lm = m.LatencyModel(kind="fixed", lo=3e-6, hi=3e-6)
    utils = [m.simulate_amu(MB, lm, m.AMUParams(outstanding=32,
                                                granularity=g),
                            link_bw=LINK).utilization
             for g in (64, 512, 4096)]
    assert utils[0] < utils[1] < utils[2]


def _little_blocking(m):
    core = m.CoreParams()
    for lat in (200e-9, 1e-6, 10e-6):
        lm = m.LatencyModel(kind="fixed", lo=lat, hi=lat)
        des = m.simulate_blocking_core(MB, lm, core, LINK)
        bound = m.little_bound_blocking(lat, core, LINK)
        assert bound * 0.5 <= des.achieved_bw <= bound * 1.02


def _little_amu(m):
    amu = m.AMUParams()
    for lat in (200e-9, 1e-6, 10e-6):
        lm = m.LatencyModel(kind="fixed", lo=lat, hi=lat)
        des = m.simulate_amu(MB, lm, amu, LINK)
        bound = m.little_bound_amu(lat, amu, LINK)
        assert bound * 0.5 <= des.achieved_bw <= bound * 1.02


def _wide_distribution(m):
    mean = 0.9 * 300e-9 + 0.1 * 10e-6
    fixed = m.simulate_blocking_core(MB, m.LatencyModel("fixed", mean, mean),
                                     link_bw=LINK)
    bimodal = m.simulate_blocking_core(
        MB, m.LatencyModel("bimodal", 300e-9, 10e-6, tail_frac=0.1),
        link_bw=LINK)
    assert bimodal.achieved_bw < fixed.achieved_bw * 1.05
    amu_fixed = m.simulate_amu(MB, m.LatencyModel("fixed", mean, mean),
                               link_bw=LINK)
    amu_bi = m.simulate_amu(MB, m.LatencyModel("bimodal", 300e-9, 10e-6,
                                               tail_frac=0.1), link_bw=LINK)
    assert amu_bi.achieved_bw > 0.8 * amu_fixed.achieved_bw


def _amu_dominates(m):
    for lat, out in ((1e-7, 4), (2e-6, 64), (1e-5, 1024)):
        lm = m.LatencyModel("fixed", lat, lat)
        sync = m.simulate_blocking_core(MB, lm, link_bw=LINK)
        asyn = m.simulate_amu(MB, lm, m.AMUParams(outstanding=out),
                              link_bw=LINK)
        assert asyn.achieved_bw >= sync.achieved_bw * 0.9


def _mlp_bounded(m):
    lm = m.LatencyModel("fixed", 2e-6, 2e-6)
    for out in (1, 7, 512):
        res = m.simulate_amu(MB, lm, m.AMUParams(outstanding=out),
                             link_bw=LINK)
        assert res.mean_mlp <= out + 1e-6


def _utilization_at_most_one(m):
    for lat in (1e-7, 1e-6, 1e-5):
        lm = m.LatencyModel("lognormal", lat, lat * 10)
        assert m.simulate_amu(MB, lm, link_bw=LINK).utilization <= 1.0
        assert m.simulate_blocking_core(MB, lm,
                                        link_bw=LINK).utilization <= 1.0


#: the assertions of ``tests/test_sim.py``, each a function of the module
#: under test (its two Hypothesis properties at fixed points)
CLAIMS = {f.__name__.lstrip("_"): f for f in (
    _sync_collapses, _amu_sustains, _speedup_grows, _granularity,
    _little_blocking, _little_amu, _wide_distribution, _amu_dominates,
    _mlp_bounded, _utilization_at_most_one)}


@pytest.mark.parametrize("claim", list(CLAIMS))
def test_paper_claims_hold_on_the_port(claim):
    CLAIMS[claim](tsim)


# ---------------------------------------------------------------------------
# paging/sim.py
# ---------------------------------------------------------------------------

#: entry point -> (args, kwargs): a point of its benchmarks/run.py sweep
#: (:128-437)
POINTS = {
    "paged_serving": ("simulate_paged_serving", (2.0,),
                      {"page_bytes": 256 << 10}),
    "paged_serving_quant": ("simulate_paged_serving", (1.0,),
                            {"page_bytes": 2 * 32 * 16 * 8 * 16 + 2 * 32 * 8
                             * 4, "bandwidth": 1.25e9}),
    "mixed_batching": ("simulate_mixed_batching", (2.0,), {}),
    "disagg": ("simulate_disagg", (1.0,), {}),
    "prefix_reuse": ("simulate_prefix_reuse", (0.75,), {}),
    "slo_schedule": ("simulate_slo_schedule", (2.0,), {}),
}


@pytest.mark.parametrize("point", list(POINTS))
def test_paging_sim_matches_reference(point):
    name, args, kw = POINTS[point]
    port = getattr(tpsim, name)(*args, **kw)
    ref = getattr(jpsim, name)(*args, **kw)
    assert list(port) == list(ref)
    assert port == ref


@pytest.mark.parametrize("kw", [{}, {"itemsize": 1,
                                     "scale_bytes_per_head": 4},
                                {"page_size": 8, "n_layers": 2,
                                 "kv_heads": 3, "head_dim": 80}])
def test_kv_page_nbytes_matches_reference(kw):
    assert tpsim.kv_page_nbytes(**kw) == jpsim.kv_page_nbytes(**kw)
    assert tpsim.kv_page_nbytes() == 256 << 10


def test_paged_serving_traced_matches_reference():
    """With the port's tracer and metrics on (``bench_obs_overhead``'s
    call, ``benchmarks/run.py:403``) the dict is unchanged and spans are
    recorded on the simulator's clock."""
    tracer = Tracer(enabled=True)
    metrics = MetricsRegistry()
    port = tpsim.simulate_paged_serving(2.0, tracer=tracer, metrics=metrics)
    assert port == jpsim.simulate_paged_serving(2.0)
    assert tracer.events and metrics.snapshot()


SPEC_SCRIPT = """
import json, sys
from repro_torch.paging.sim import simulate_spec_decode
print(json.dumps([simulate_spec_decode(2.0, traffic=t, vocab=v)
                  for t, v in (("repetitive", 512), ("adversarial", 16))]))
"""


def test_spec_decode_is_reproducible_across_processes():
    """The streams seed from a string: the same dicts on a second call
    and in another process with another ``PYTHONHASHSEED``."""
    here = [tpsim.simulate_spec_decode(2.0, traffic=t, vocab=v)
            for t, v in (("repetitive", 512), ("adversarial", 16))]
    assert here == [tpsim.simulate_spec_decode(2.0, traffic=t, vocab=v)
                    for t, v in (("repetitive", 512), ("adversarial", 16))]
    seed = "1" if os.environ.get("PYTHONHASHSEED") == "12345" else "12345"
    env = dict(os.environ, PYTHONHASHSEED=seed,
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", SPEC_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(res.stdout) == here


@pytest.mark.parametrize("traffic", ["repetitive", "adversarial"])
@pytest.mark.parametrize("oversub", [0.5, 2.0])
def test_spec_decode_counters_balance(traffic, oversub):
    r = tpsim.simulate_spec_decode(oversub, traffic=traffic,
                                   vocab=512 if traffic == "repetitive"
                                   else 16)
    assert 0 <= r["accepted"] <= r["drafted"]
    assert 0.0 <= r["acceptance_rate"] <= 1.0
    assert r["mean_accepted_k"] <= 4
    if traffic == "repetitive":
        assert r["throughput_speedup"] > 1.5 and r["acceptance_rate"] > 0.9


def test_spec_decode_reference_refuses_this_python():
    """The deviation the port works around: the reference's tuple seed
    raises on Python 3.11 and later."""
    if sys.version_info < (3, 11):
        pytest.skip("tuple seeds are accepted before Python 3.11")
    with pytest.raises(TypeError):
        jpsim.simulate_spec_decode(0.5)
    with pytest.raises(ValueError):
        tpsim.simulate_spec_decode(0.5, traffic="bursty")


# ---------------------------------------------------------------------------
# far_memory_stream
# ---------------------------------------------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "far_memory_stream_example", ROOT / "examples" / "far_memory_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_far_memory_stream_matches_the_example(monkeypatch):
    """Blocks and compute 64 times smaller on both module objects (the
    same arithmetic on 1 GiB less memory): the times by depth and every
    printed line equal the example's."""
    example = _example()
    for mod in (example, far_memory_stream):
        monkeypatch.setattr(mod, "BYTES_PER_LAYER", 1 << 20)
        monkeypatch.setattr(mod, "T_COMPUTE", 8e-3 / 64)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example.main()
    want = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = far_memory_stream.main(["--device", "cpu"])
    assert buf.getvalue() == want
    assert got == {d: example.run(d) for d in (0, 1, 2, 4)}


def test_chip_smoke_pins_the_example_times():
    """``chip_smoke.FAR_STREAM_S``, which the card run must print, is the
    example's virtual time at its own 64 MiB blocks (numpy allocates them
    lazily, so the full size is cheap here)."""
    import chip_smoke
    example = _example()
    assert chip_smoke.FAR_STREAM_S == {d: example.run(d)
                                       for d in (0, 1, 2, 4)}
    assert tuple(chip_smoke.FAR_STREAM_S)[1:] == far_memory_stream.DEPTHS
