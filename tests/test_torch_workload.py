"""The production traffic model and the workload / SLO serving CLI of the
port against the JAX package, on the CPU.

``repro_torch.serve.workload.generate`` must draw the reference's trace
field for field.  The port's CLI (``--workload``, ``--slo``) must serve
that trace on phi4-mini-3.8b SMOKE like the reference's CLI: the same
flags, bridged JAX weights with ``compute_dtype="float32"``, equal
greedy tokens per request and an equal ``slo_report`` on the virtual
clock.  ``--dense`` serves with paging off.  Last, the CPU rehearsal of
``chip_smoke.py`` phase 3w (one smoke-width layer with the full width's
page bytes: scheduling reads shapes and page bytes only).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.launch import serve as jax_cli
from repro.models import model as jmodel
from repro.serve import engine as jengine_mod
from repro.serve.config import Tier as JaxTier
from repro.serve.workload import WorkloadSpec as JaxSpec
from repro.serve.workload import generate as jax_generate
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import Tier, WorkloadRequest, WorkloadSpec, generate
from repro_torch.serve.config import (ChunkingConfig, EngineConfig,
                                      PagingConfig, SchedulerConfig)
from repro_torch.serve.engine import Engine

ARCH = "phi4-mini-3.8b"
#: the flags both CLIs get (the port's also ``--device cpu``)
FLAGS = ["--arch", ARCH, "--smoke", "--requests", "12", "--chunk-tokens",
         "16", "--page-size", "16", "--device-pages", "24", "--workload"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The JAX engines compile per engine: torch on one thread leaves the
    cores to XLA's compiler when tests run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the traffic model
# ---------------------------------------------------------------------------

def _fields(req):
    return (req.rid, req.arrival_t, req.prompt_len, req.output_len,
            int(req.tier), req.tier.name, req.ttft_slo, req.tpot_slo)


SPECS = {
    "default": {},
    "cli-full-width": {"max_prompt": 1024},
    "bursty-batch": {"rate": 50.0, "burstiness": 4.0, "diurnal_amp": 0.9,
                     "interactive_frac": 0.2, "batch_ttft_slo": 0.5,
                     "batch_tpot_slo": 0.05},
    "smooth-long": {"rate": 1000.0, "burstiness": 0.5, "diurnal_amp": 0.0,
                    "prompt_median": 300.0, "max_prompt": 4096,
                    "zipf_a": 1.2, "max_output": 512},
}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("spec", list(SPECS))
def test_generate_matches_reference(spec, seed):
    kw = SPECS[spec]
    port = generate(64, WorkloadSpec(**kw), seed=seed)
    ref = jax_generate(64, JaxSpec(**kw), seed=seed)
    assert [_fields(r) for r in port] == [_fields(r) for r in ref]
    assert all(isinstance(r, WorkloadRequest) and isinstance(r.tier, Tier)
               for r in port)
    assert [int(t) for t in Tier] == [int(t) for t in JaxTier]


def test_generate_edge_cases():
    assert generate(0) == [] == jax_generate(0)
    one = generate(1, WorkloadSpec(interactive_frac=1.0), seed=3)
    assert [_fields(r) for r in one] == \
        [_fields(r) for r in jax_generate(1, JaxSpec(interactive_frac=1.0),
                                          seed=3)]
    assert one[0].tier is Tier.INTERACTIVE and one[0].ttft_slo == 0.020


# ---------------------------------------------------------------------------
# the CLI against the reference's CLI
# ---------------------------------------------------------------------------

#: jitted steps of the JAX engines, shared between engines of one config
_JAX_STEPS = {}


def _shared(make):
    def factory(cfg, mesh, shape, **kw):
        key = repr((make.__name__, repr(cfg), repr(shape),
                    sorted(kw.items())))
        if key not in _JAX_STEPS:
            _JAX_STEPS[key] = make(cfg, mesh, shape, **kw)
        return _JAX_STEPS[key]
    return factory


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _run_cli(module, argv, cfg, params, engine_cls, mp):
    """``module.main(argv)`` on ``cfg`` and ``params`` (the CLI's own
    draw replaced); returns (engine, outputs)."""
    made = []

    class Recording(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    mp.setattr(module, "get_smoke", lambda arch: cfg)
    mp.setattr(module, "init_params", lambda *a, **kw: params)
    mp.setattr(module, "Engine", Recording)
    out = module.main(argv)
    (eng,) = made
    return eng, out


@pytest.fixture(scope="module")
def cli_runs(weights):
    """Both CLIs with and without ``--slo``, on the same weights."""
    jcfg, tcfg, jp, tp = weights
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_serve_step", "make_mixed_step"):
            mp.setattr(jengine_mod, name, _shared(getattr(jengine_mod, name)))
        for policy, extra in (("slo", ["--slo"]), ("watermark", [])):
            runs[policy] = (
                _run_cli(serve_cli, FLAGS + extra + ["--device", "cpu"],
                         tcfg, tp, serve_cli.Engine, mp),
                _run_cli(jax_cli, FLAGS + extra, jcfg, jp, jax_cli.Engine,
                         mp))
    return runs


@pytest.mark.parametrize("policy", ["slo", "watermark"])
def test_workload_cli_matches_reference_cli(cli_runs, policy):
    """Greedy tokens per request, the engines' counters and the per-tier
    ``slo_report`` on the virtual clock, equal to the reference CLI's."""
    (teng, tout), (jeng, jout) = cli_runs[policy]
    assert teng.sched_cfg.policy == jeng.sched_cfg.policy == policy
    assert sorted(tout) == list(range(12))
    assert tout == jout
    for key in ("steps", "chunks", "mixed_steps", "preemptions", "resumes",
                "shed_admissions", "deadline_misses", "admitted"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.slo_report() == jeng.slo_report()
    tiers = {r.tier for r in teng.finished.values()}
    assert tiers == {Tier.INTERACTIVE, Tier.BATCH}


def test_workload_cli_prints_the_slo_lines(weights, capsys):
    """``--slo`` without ``--workload`` prints the per-tier lines too."""
    _, tcfg, _, tp = weights
    with pytest.MonkeyPatch.context() as mp:
        _run_cli(serve_cli, ["--arch", ARCH, "--smoke", "--requests", "3",
                             "--max-new", "3", "--slo", "--device", "cpu"],
                 tcfg, tp, serve_cli.Engine, mp)
    text = capsys.readouterr().out
    assert "[serve] interactive: 3 reqs, attainment" in text
    assert "[serve] batch: 0 reqs" in text
    assert "[serve] scheduler: policy=slo" in text


def test_dense_flag_serves_without_paging(weights, capsys):
    _, tcfg, _, tp = weights
    with pytest.MonkeyPatch.context() as mp:
        eng, out = _run_cli(serve_cli, FLAGS + ["--dense", "--device",
                                                "cpu"], tcfg, tp,
                            serve_cli.Engine, mp)
    assert not eng.paging and eng.pager is None
    assert sorted(out) == list(range(12))
    assert all(len(out[r.rid]) == r.max_new_tokens
               for r in eng.finished.values())
    assert eng.stats["prefills"] == 12
    assert "dense per-slot cache" in capsys.readouterr().out


def test_wall_clock_arrival_after_the_admission_read(weights):
    """An injected clock that passes the first arrival between the
    admission's read and the idle check: the engine waits a step and
    admits it, where reading the clock again made it raise that the
    queue can never be admitted."""
    _, tcfg, _, tp = weights
    t = [0.0]

    class Stepping(Engine):
        def _admit(self):
            super()._admit()
            t[0] += 0.3             # the wall clock runs on after the read

    eng = Stepping(tcfg, tp, EngineConfig(
        max_batch=2, max_len=64, device="cpu",
        scheduler=SchedulerConfig(clock=lambda: t[0]),
        paging=PagingConfig(page_size=16, device_pages=24),
        chunking=ChunkingConfig(chunk_tokens=16)))
    for i in range(3):
        eng.submit(np.arange(5 + i), max_new_tokens=3, arrival_t=0.5 + i)
    out = eng.run()
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 3 for v in out.values())


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py phase 3w
# ---------------------------------------------------------------------------

def test_chip_smoke_phase3w_rehearsal():
    """Phase 3w's trace on phase 3's settings, each policy: every request
    finishes with its count, the counters balance, and the run's counts
    and virtual-clock ``slo_report`` are what the card run is held to."""
    import chip_smoke
    reh = chip_smoke.workload_rehearsal()
    assert set(reh) == {"watermark", "slo"}
    trace = generate(chip_smoke.WORKLOAD_REQUESTS,
                     WorkloadSpec(max_prompt=1024), seed=chip_smoke.SEED)
    for policy, counts in reh.items():
        assert counts["requests"] == chip_smoke.WORKLOAD_REQUESTS
        assert counts["tokens"] == sum(r.output_len for r in trace)
        rep = counts["slo_report"]
        assert rep["interactive"]["n"] + rep["batch"]["n"] == \
            chip_smoke.WORKLOAD_REQUESTS
        assert counts["resumes"] == counts["preemptions"]
    # the same trace and the same steps; the SLO policy orders the
    # interactive tier's prefill chunks first
    wm, slo = (reh[p]["slo_report"]["interactive"] for p in ("watermark",
                                                              "slo"))
    assert reh["slo"]["steps"] == reh["watermark"]["steps"]
    assert slo["ttft_p95"] < wm["ttft_p95"]
