"""llama4-maverick-400b-a17b's grouped MoE stack served by the port's
engine against the JAX package's engine, on bridged weights.

The ``llama4-maverick-400b-a17b`` SMOKE config (4 layers in two groups of
a dense layer and an MoE layer, 8 experts top-1 and a shared expert)
with f32 compute, weights made by the JAX ``init_params`` and moved over
by ``repro_torch.bridge``.  The engines — chunked and paged under
preemption, on the bf16 and the int8 pool, the dense prefill, paging
off, and speculative verify with an injected proposer — must give the
JAX engines' greedy tokens and counters; the prefix cache and the
finished-sequence offload serve the grouped stack.  The model-level
comparisons are ``tests/test_torch_grouped_moe.py``'s.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import model as jmodel
from repro.serve import config as jconf
from repro.serve import engine as jengine_mod
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.models import model as tmodel
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine

ARCH = "llama4-maverick-400b-a17b"
LENGTHS = [13, 6, 17, 9, 20, 5]
MAX_NEW = 7
K = 2
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted", "prefills")
SPEC_COUNTERS = ("steps", "spec_steps", "drafted", "accepted", "rejected",
                 "preemptions", "resumes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The JAX engines compile per engine: torch on one thread leaves the
    cores to XLA's compiler when tests run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jparams = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _econf(mod, pages=10, chunk=8, enabled=None, kv_quant="none",
           speculate_k=0, factory=None, **extra):
    return mod.EngineConfig(
        max_batch=3, max_len=32, prefill_buckets=(32,),
        paging=mod.PagingConfig(enabled=enabled, page_size=4,
                                device_pages=pages, hot_tail_pages=1,
                                kv_quant=kv_quant),
        chunking=mod.ChunkingConfig(chunk_tokens=chunk, chunk_slots=2),
        speculation=mod.SpeculationConfig(speculate_k=speculate_k,
                                          speculate_ngram=2,
                                          proposer_factory=factory),
        **extra)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n) for n in LENGTHS]


def _serve(engine_cls, cfg, params, econf, prompts):
    eng = engine_cls(cfg, params, econf)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    return eng, eng.run()


class _Oracle:
    """Drafts a reference run's continuation, the first draft of every
    verify step shifted by one id on odd rids: accepted runs and
    rejections both occur."""

    def __init__(self, refs, prompt_lens, k, vocab):
        self.refs, self.prompt_lens, self.k = refs, prompt_lens, k
        self.vocab = vocab

    def propose(self, rid, history):
        n = len(history) - self.prompt_lens[rid]
        draft = list(self.refs[rid][n:n + self.k])
        if draft and rid % 2:
            draft[0] = (draft[0] + 1) % self.vocab
        return draft

    def drop(self, rid):
        pass


#: jitted steps of the JAX engines, shared between engines of one config
_JAX_STEPS = {}


def _shared(make):
    """The JAX package's step factory, memoized on its arguments: engines
    of one config run one jitted program instead of compiling their own
    copy of it."""
    def factory(cfg, mesh, shape, **kw):
        key = repr((make.__name__, repr(cfg), repr(shape),
                    sorted(kw.items())))
        if key not in _JAX_STEPS:
            _JAX_STEPS[key] = make(cfg, mesh, shape, **kw)
        return _JAX_STEPS[key]
    return factory


#: id -> engine options (both packages): every paged case preempts in
#: the reference
CASES = {
    "chunked": {},
    "chunked-int8": {"kv_quant": "int8"},
    "dense-prefill": {"chunk": None, "pages": 8},
    "non-paged": {"chunk": None, "enabled": False, "pages": None},
}


@pytest.fixture(scope="module")
def engines(setup):
    """Per case: the port's engine and the JAX package's on the same
    prompts; then the speculative pair with the oracle drafts of the
    chunked case's tokens."""
    jcfg, tcfg, jparams, tparams = setup
    prompts = _prompts(tcfg.vocab_size)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_serve_step", "make_mixed_step"):
            mp.setattr(jengine_mod, name, _shared(getattr(jengine_mod, name)))
        for case, kw in CASES.items():
            runs[case] = (
                _serve(Engine, tcfg, tparams, _econf(tconf, device="cpu",
                                                     **kw), prompts),
                _serve(JaxEngine, jcfg, jparams, _econf(jconf, **kw),
                       prompts))
        lens = {i: len(p) for i, p in enumerate(prompts)}
        refs = runs["chunked"][0][1]

        def factory(n, k):
            return _Oracle(refs, lens, k, tcfg.padded_vocab)
        runs["spec"] = (
            _serve(Engine, tcfg, tparams, _econf(
                tconf, speculate_k=K, factory=factory, device="cpu"),
                prompts),
            _serve(JaxEngine, jcfg, jparams, _econf(
                jconf, speculate_k=K, factory=factory), prompts))
    return prompts, runs


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(engines, case):
    """Greedy tokens, counters and (paged) pager traffic equal the JAX
    engine's; the paged cases preempt and resume, the dense-prefill ones
    admit every prompt through the whole-prompt prefill."""
    prompts, runs = engines
    (teng, tout), (jeng, jout) = runs[case]
    assert sorted(tout) == list(range(len(LENGTHS)))
    assert all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout
    assert {k: teng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    kw = CASES[case]
    if kw.get("chunk", 8) is None:
        assert teng.stats["prefills"] == len(prompts)
    if kw.get("enabled") is False:
        assert teng.pager is None
        return
    assert teng.stats["preemptions"] > 0 and teng.stats["resumes"] > 0
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)
    assert teng.cache.kv["k_pages"].dtype == (
        torch.int8 if kw.get("kv_quant") == "int8" else torch.bfloat16)


def test_spec_engine_matches_jax_spec_engine(engines):
    """Speculative verify-K decode with the injected oracle: the JAX spec
    engine's tokens and counters, both accepts and rejects."""
    _, runs = engines
    (teng, tout), (jeng, jout) = runs["spec"]
    assert tout == jout
    assert {k: teng.stats[k] for k in SPEC_COUNTERS} == \
        {k: jeng.stats[k] for k in SPEC_COUNTERS}
    assert teng.stats["accepted"] > 0 and teng.stats["rejected"] > 0
    assert teng.stats["accepted"] + teng.stats["rejected"] == \
        teng.stats["drafted"]
    teng.check_invariants()


def test_oversubscribed_pool_matches_roomy_pool(setup, engines):
    """Parking and resuming pages changes no token."""
    _, tcfg, _, tparams = setup
    prompts, runs = engines
    (teng, tout), _ = runs["chunked"]
    roomy, rout = _serve(Engine, tcfg, tparams,
                         _econf(tconf, pages=None, device="cpu"), prompts)
    assert roomy.stats["preemptions"] == 0 < teng.stats["preemptions"]
    assert rout == tout


def test_dense_prefill_and_chunk_queue_part_by_capacity(engines):
    """The dense prefill routes a whole bucket, pads included, through
    each MoE layer at once; the chunk queue routes a chunk at a time.
    Expert capacity C = ceil(S·k/E · capacity_factor) then drops other
    pairs, so the two give other tokens: in the JAX engines as in the
    port's."""
    _, runs = engines
    for side in (0, 1):
        assert runs["chunked"][side][1] != runs["dense-prefill"][side][1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_without_drops_dense_prefill_equals_chunk_queue(setup, dtype):
    """With a capacity that drops no pair (capacity_factor E/k: C = S),
    the dense prefill's tokens equal the chunk queue's, in f32 and in
    bf16 compute: capacity alone parts them."""
    _, tcfg, _, tparams = setup
    cfg = dataclasses.replace(
        tcfg, compute_dtype=dtype,
        capacity_factor=tcfg.num_experts / tcfg.experts_per_token)
    prompts = _prompts(cfg.vocab_size)
    _, queue = _serve(Engine, cfg, tparams,
                      _econf(tconf, pages=None, device="cpu"), prompts)
    eng, dense = _serve(Engine, cfg, tparams, _econf(
        tconf, chunk=None, pages=None, device="cpu"), prompts)
    assert eng.stats["prefills"] == len(prompts)
    assert dense == queue


@pytest.mark.parametrize("options", [
    {"prefix_cache": True},
    {"offload_finished": True},
])
def test_engine_options_serve_llama4(setup, options):
    """The prefix cache and the finished-sequence offload admit the
    grouped family, as the reference's gates do: every request finishes
    with its count, tokens equal the plain engine's."""
    _, tcfg, _, tparams = setup
    prompts = _prompts(tcfg.vocab_size)
    shared = np.random.default_rng(1).integers(0, tcfg.vocab_size, 8)
    prompts = [np.concatenate([shared, p]) for p in prompts[:4]]
    econf = _econf(tconf, pages=None, device="cpu")
    _, ref = _serve(Engine, tcfg, tparams, econf, prompts)
    econf = dataclasses.replace(
        econf,
        paging=dataclasses.replace(
            econf.paging,
            offload_finished=options.get("offload_finished", False)),
        chunking=dataclasses.replace(
            econf.chunking, prefix_cache=options.get("prefix_cache", False)))
    eng, out = _serve(Engine, tcfg, tparams, econf, prompts)
    assert out == ref
    if "prefix_cache" in options:
        assert eng.stats["prefix_hits"] > 0
    else:
        fetched = eng.fetch_finished(0)
        assert fetched.kv["k"].shape[0] == tcfg.num_layers


def test_random_init_serves_smoke_config():
    cfg = get_smoke(ARCH)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng, out = _serve(Engine, cfg, params, _econf(tconf, device="cpu"),
                      _prompts(cfg.vocab_size))
    assert all(len(out[r]) == MAX_NEW for r in range(len(LENGTHS)))
    assert eng.stats["preemptions"] > 0


@pytest.mark.parametrize("change", [dict(num_layers=3),
                                    dict(family="encdec")])
def test_engine_refuses_unported_layouts(change):
    """Groups must tile the stack (3 layers of moe_every 2 do not, and
    the reference's reshape would fail), and the enc-dec family is not
    ported."""
    cfg = dataclasses.replace(get_smoke(ARCH), **change)
    with pytest.raises(NotImplementedError):
        Engine(cfg, {}, _econf(tconf, device="cpu"))
    with pytest.raises(NotImplementedError):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
