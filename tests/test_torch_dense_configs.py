"""The rest of the dense family in the port against the JAX package, on
the CPU: mistral-nemo-12b, h2o-danube-1.8b (sliding window),
command-r-plus-104b (qk-norm, tied embeddings, logit scale) and
qwen2-vl-72b (M-RoPE).

Each config equals the reference's field for field, and the port's
``init_params`` gives the JAX tree's paths and shapes.  On the SMOKE
configs with f32 compute and weights made by the JAX ``init_params``
(moved over by ``repro_torch.bridge``), every input numpy-seeded: M-RoPE,
the whole-prompt dense prefill and the dense (non-paged) decode agree
with the JAX functions to 2e-6 (the caches' K/V to 2e-6 of their
largest magnitude: a K of 1.7 is a sum of 64 products, which the two
frameworks add in other orders), and the paged, chunked engine gives the
JAX engine's greedy tokens and counters on a pool where both preempt.
The prefill and decode comparisons give both sides an f32 dense cache
(the reference's is bf16, where an f32 K that differs in its last bits
may round to the neighbouring bf16 value); the engines keep bf16.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve import config as jconf
from repro.serve.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine
from repro_torch.steps import make_serve_step

NEW = ("mistral-nemo-12b", "h2o-danube-1.8b", "command-r-plus-104b",
       "qwen2-vl-72b")
TOL = 2e-6
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted", "prefills")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _close_kv(a, b, tol=TOL):
    """K/V within ``tol`` of the tensor's largest magnitude."""
    b = np.asarray(b, np.float32)
    _close(a, b, tol * max(1.0, float(np.abs(b).max())))


_WEIGHTS = {}


def weights(arch):
    """(JAX config, port config, JAX params, port params) of ``arch``'s
    SMOKE config with f32 compute, made once per module."""
    if arch not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   compute_dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                                   compute_dtype="float32")
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _WEIGHTS[arch] = (jcfg, tcfg, jp, tp)
    return _WEIGHTS[arch]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_registry_holds_the_six_served_archs():
    assert tconfigs.ARCH_IDS == [
        "rwkv6-7b", "seamless-m4t-medium", "qwen2-vl-72b",
        "mistral-nemo-12b", "command-r-plus-104b", "h2o-danube-1.8b",
        "phi4-mini-3.8b", "olmoe-1b-7b", "llama4-maverick-400b-a17b",
        "zamba2-1.2b"]
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch, which):
    port = getattr(tconfigs, which)(arch)
    ref = getattr(jconfigs, which)(arch)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.head_dim == ref.head_dim and port.padded_vocab == \
        ref.padded_vocab and port.param_count() == ref.param_count()


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", NEW)
def test_init_params_gives_the_jax_tree(arch):
    """Paths and shapes of the port's own draw equal the JAX tree's:
    command-r's ``q_norm``/``k_norm`` and no ``lm_head`` (tied)."""
    cfg = tconfigs.get_smoke(arch)
    own = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda: jmodel.init_params(
        jconfigs.get_smoke(arch), jax.random.PRNGKey(0)))
    assert _shapes(own) == _shapes(ref)
    attn = own["layers"]["attn"]
    assert ("q_norm" in attn and "k_norm" in attn) == cfg.qk_norm
    assert ("lm_head" in own) != cfg.tie_embeddings


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,sections", [(16, (4, 2, 2)),
                                               (128, (16, 24, 24))])
def test_mrope_matches_jax(head_dim, sections):
    """Distinct (t, h, w) ids, the SMOKE and the full config's sections."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    ref = jlayers.mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = tlayers.mrope(torch.from_numpy(x), torch.from_numpy(pos),
                        sections, 1e6)
    _close(got.numpy(), np.asarray(ref), 1e-6)


def test_mrope_with_equal_ids_is_rope_bitwise():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 16))
                         .astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 9)).astype(np.int32))
    got = tlayers.mrope(x, pos.expand(3, 2, 9), (4, 2, 2))
    assert torch.equal(got, tlayers.rope(x, pos))
    xb = x.bfloat16()
    assert torch.equal(tlayers.mrope(xb, pos.expand(3, 2, 9), (4, 2, 2)),
                       tlayers.rope(xb, pos))


@pytest.mark.parametrize("sections", [(4, 2, 1), (8, 2, 2), ()])
def test_mrope_bad_sections_raise(sections):
    x = torch.zeros((1, 2, 1, 16))
    pos = torch.zeros((3, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="sum"):
        tlayers.mrope(x, pos, sections)
    with pytest.raises(ValueError, match="sum"):
        jlayers.mrope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()),
                      sections)


# ---------------------------------------------------------------------------
# the dense prefill and the dense decode
# ---------------------------------------------------------------------------

@pytest.fixture
def f32_caches(monkeypatch):
    """Both packages' dense caches in f32 for the duration of a test."""
    monkeypatch.setattr(jmodel, "init_kv_cache",
                        partial(jattn.init_kv_cache, dtype=jnp.float32))
    monkeypatch.setattr(tmodel, "init_kv_cache",
                        partial(tattn.init_kv_cache, dtype=torch.float32))


#: (arch, rows, tokens, max_len): danube's window of 8 is shorter than
#: 20 tokens, so that cache is the rolled ring of the last 8
PREFILL_CASES = [("mistral-nemo-12b", 2, 12, 32),
                 ("h2o-danube-1.8b", 2, 6, 32),
                 ("h2o-danube-1.8b", 2, 20, 32),
                 ("command-r-plus-104b", 1, 12, 32),
                 ("qwen2-vl-72b", 2, 12, 32)]


def _prefill_both(arch, B, S, max_len):
    jcfg, tcfg, jp, tp = weights(arch)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.full((B,), S - 3, np.int32)      # the prompt inside a bucket
    jpre = jax.jit(partial(jmodel.prefill, cfg=jcfg, max_len=max_len),
                   static_argnames=())
    jl, jc = jpre(jp, batch={"tokens": jnp.asarray(toks)},
                  last_pos=jnp.asarray(last))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                            max_len=max_len, last_pos=torch.from_numpy(last))
    return (jcfg, tcfg, jp, tp), (jl, jc), (tl, tc)


@pytest.mark.parametrize("arch,B,S,max_len", PREFILL_CASES)
def test_dense_prefill_matches_jax(f32_caches, arch, B, S, max_len):
    _, (jl, jc), (tl, tc) = _prefill_both(arch, B, S, max_len)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl.numpy(), np.asarray(jl))
    for key in ("k", "v"):
        assert tuple(tc.kv[key].shape) == jc.kv[key].shape
        _close_kv(tc.kv[key].numpy(), jc.kv[key])
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert int(tc.kv["slots"]) == int(jc.kv["slots"])


@pytest.mark.parametrize("arch,B,S,max_len", PREFILL_CASES)
def test_dense_decode_matches_jax(f32_caches, arch, B, S, max_len):
    """Ten decode steps on the prefilled dense cache: danube's rows wrap
    the ring (position p at slot p % 8) from its first or a later
    step."""
    (jcfg, tcfg, jp, tp), (_, jc), (_, tc) = _prefill_both(arch, B, S,
                                                           max_len)
    jdec = jax.jit(partial(jmodel.decode_step, cfg=jcfg))
    step = make_serve_step(tcfg, paged=False)
    rng = np.random.default_rng(100 + S)
    for _ in range(10):
        toks = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jdec(jp, cache=jc, tokens=jnp.asarray(toks))
        tl, tc = step(tp, tc, torch.from_numpy(toks))
        _close(tl.numpy(), np.asarray(jl))
    for key in ("k", "v"):
        _close_kv(tc.kv[key].numpy(), jc.kv[key])
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_serve_step_checks_the_layout():
    cfg = tconfigs.get_smoke("mistral-nemo-12b")
    cache = tmodel.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(TypeError, match="PagedCache"):
        make_serve_step(cfg)({}, cache, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="paged"):
        make_serve_step(cfg, 2, paged=False)


# ---------------------------------------------------------------------------
# the paged, chunked engine
# ---------------------------------------------------------------------------

#: arch -> (prompt lengths, new tokens, device pages, chunk tokens); each
#: pool is small enough that the reference preempts and resumes.
#: danube's prompts fit its 8-token ring (the chunk queue takes them);
#: its decode wraps the ring
ENGINE_CASES = {
    "mistral-nemo-12b": ([13, 6, 17, 9, 20, 5], 7, 10, 8),
    "h2o-danube-1.8b": ([3, 6, 2, 8, 4, 7, 3], 9, 5, 4),
    "command-r-plus-104b": ([13, 6, 17, 9, 20, 5], 7, 10, 8),
    "qwen2-vl-72b": ([13, 6, 17, 9, 20, 5], 7, 10, 8),
}


def _econf(mod, pages, chunk, **extra):
    return mod.EngineConfig(
        max_batch=3, max_len=32, prefill_buckets=(8, 16, 32),
        paging=mod.PagingConfig(page_size=4, device_pages=pages,
                                hot_tail_pages=1),
        chunking=mod.ChunkingConfig(chunk_tokens=chunk, chunk_slots=2),
        **extra)


def _serve(engine_cls, cfg, params, econf, prompts, new):
    eng = engine_cls(cfg, params, econf)
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    return eng, eng.run()


@pytest.mark.parametrize("arch", NEW)
def test_chunked_engine_matches_jax_engine(arch):
    jcfg, tcfg, jp, tp = weights(arch)
    lens, new, pages, chunk = ENGINE_CASES[arch]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in lens]
    jeng, jout = _serve(JaxEngine, jcfg, jp, _econf(jconf, pages, chunk),
                        prompts, new)
    teng, tout = _serve(Engine, tcfg, tp,
                        _econf(tconf, pages, chunk, device="cpu"), prompts,
                        new)
    assert tout == jout
    assert {k: teng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    assert teng.stats["preemptions"] > 0 and teng.stats["resumes"] > 0
    assert teng.stats["prefills"] == 0 and teng.stats["chunks"] > 0
