"""The port's serving engine against the JAX engine, end to end on the CPU.

Bridged f32 weights of the ``phi4-mini-3.8b`` SMOKE config, FUSED role,
paging and chunked prefill on, watermark policy, and a device pool too
small for the offered load, so both engines preempt, park pages in the
far tier and resume them.  The host logic is a copy and both engines
run on the same virtual clock, so they must make the same scheduling
decisions (same counters) and, on the same weights, emit the same
greedy tokens.  Inside the port, the oversubscribed run must emit
exactly the tokens of a run whose pool never preempts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serve import config as jconf
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.models.model import init_params
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine

LENGTHS = [13, 6, 17, 9, 20, 5]
MAX_NEW = 7
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _econf(mod, device_pages, **extra):
    return mod.EngineConfig(
        max_batch=3, max_len=32,
        paging=mod.PagingConfig(page_size=4, device_pages=device_pages,
                                hot_tail_pages=1),
        chunking=mod.ChunkingConfig(chunk_tokens=8, chunk_slots=2),
        **extra)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n) for n in LENGTHS]


def _serve(engine_cls, cfg, params, econf, prompts):
    eng = engine_cls(cfg, params, econf)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    return eng, eng.run()


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    prompts = _prompts(tcfg.vocab_size)
    jeng, jout = _serve(JaxEngine, jcfg, jparams, _econf(jconf, 10), prompts)
    teng, tout = _serve(Engine, tcfg, tparams,
                        _econf(tconf, 10, device="cpu"), prompts)
    return tcfg, tparams, prompts, (jeng, jout), (teng, tout)


def test_engine_tokens_match_jax_engine(setup):
    _, _, _, (jeng, jout), (teng, tout) = setup
    assert jeng.stats["preemptions"] > 0 and jeng.stats["resumes"] > 0
    assert sorted(tout) == sorted(jout) == list(range(len(LENGTHS)))
    assert all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout


@pytest.mark.parametrize("name", COUNTERS)
def test_engine_counters_match_jax_engine(setup, name):
    _, _, _, (jeng, _), (teng, _) = setup
    assert teng.stats[name] == jeng.stats[name]


def test_engine_pager_traffic_matches_jax_engine(setup):
    """Same parks, writebacks, prefetches and clean evictions."""
    _, _, _, (jeng, _), (teng, _) = setup
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)
    assert teng.page_pool.n_free == teng.page_pool.n_pages


def test_oversubscribed_pool_matches_roomy_pool_bitwise(setup):
    tcfg, tparams, prompts, _, (teng, tout) = setup
    roomy, rout = _serve(Engine, tcfg, tparams,
                         _econf(tconf, None, device="cpu"), prompts)
    assert roomy.stats["preemptions"] == 0
    assert teng.stats["preemptions"] > 0
    assert rout == tout


def test_random_init_serves_smoke_config():
    """The port's own ``init_params`` (no JAX weights) drives the engine:
    every request finishes with its token count."""
    cfg = get_smoke("phi4-mini-3.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng, out = _serve(Engine, cfg, params, _econf(tconf, 10, device="cpu"),
                      _prompts(cfg.vocab_size))
    assert all(len(out[r]) == MAX_NEW for r in range(len(LENGTHS)))
    assert eng.stats["preemptions"] > 0


#: a family the port still refuses for each case: the dense smoke config
#: with experts, the enc-dec family
_DENSE_WITH_EXPERTS = {"num_experts": 4, "experts_per_token": 2}
_ENCDEC = {"family": "encdec"}


@pytest.mark.parametrize("change", [
    ({"role": "prefill",
      "chunking": tconf.ChunkingConfig(chunk_tokens=None)}, _ENCDEC),
    ({"role": "decode",
      "chunking": tconf.ChunkingConfig(chunk_tokens=None)},
     _DENSE_WITH_EXPERTS),
    ({"chunking": tconf.ChunkingConfig(chunk_tokens=None)},
     _DENSE_WITH_EXPERTS),
    ({"paging": tconf.PagingConfig(enabled=False)}, _ENCDEC),
    ({"paging": tconf.PagingConfig(offload_finished=True),
      "chunking": tconf.ChunkingConfig(chunk_tokens=None)},
     _DENSE_WITH_EXPERTS),
])
def test_unported_options_raise(change):
    """Every engine option the JAX engine accepts is served (the roles,
    offload, unset ``chunk_tokens``, ``paging.enabled=False``); each case
    pairs one with a model family the port still refuses — dense with
    experts, enc-dec — which raises ``NotImplementedError`` whatever the
    options."""
    econf_change, cfg_change = change
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), **cfg_change)
    econf = dataclasses.replace(tconf.EngineConfig(device="cpu"),
                                **econf_change)
    with pytest.raises(NotImplementedError):
        Engine(cfg, {}, econf)


def test_prompt_longer_than_slot_raises():
    cfg = get_smoke("phi4-mini-3.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, _econf(tconf, None, device="cpu"))
    with pytest.raises(NotImplementedError):
        eng.submit(np.zeros(33, np.int32))


def test_chip_smoke_settings_preempt_and_resume():
    """``chip_smoke.py``'s full-width engine settings (pool, batch,
    chunking, the 12 requests) make the watermark engine preempt and
    resume.  Scheduling reads only shapes and the pager's page size in
    bytes, never the model's numbers, so one smoke-width layer with the
    full width's page bytes makes the same decisions the card run
    makes."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.paging import Pager

    full = get_config("phi4-mini-3.8b")
    full_nbytes = (2 * full.num_layers * chip_smoke.ENGINE["page_size"]
                   * full.num_kv_heads * full.head_dim * 2)   # bf16 K + V

    def pager_factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=full_nbytes)

    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), num_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    econf = chip_smoke.engine_config("cpu", chip_smoke.ENGINE["device_pages"])
    econf = dataclasses.replace(econf, paging=dataclasses.replace(
        econf.paging, pager_factory=pager_factory))
    eng = Engine(cfg, params, econf)
    for p in chip_smoke.prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
    out = eng.run()
    assert len(out) == chip_smoke.N_REQUESTS
    assert all(len(v) == chip_smoke.NEW_TOKENS for v in out.values())
    assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
