"""The encoder-decoder family (seamless-m4t-medium) in the port against
the JAX package, on the CPU.

The ``seamless-m4t-medium`` SMOKE config (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16) with f32 compute, weights made by the JAX
``init_params`` and moved over by ``repro_torch.bridge``; the stub
frontend's frame embeddings (``src_embeds``) and the tokens come from
numpy seeds.  Model level at 2e-6: the encoder, ``encode_cross``,
``prefill`` with its cross state, ``decode_step`` on the dense and the
paged cache (cross rows past a source's length left in place),
``prefill_chunk`` with rows of different source lengths and an inert
row, and the cross-attention helpers' plain versions against the
reference's masked ``chunked_attention``.  Engine level: greedy tokens
and counters equal to the JAX engine's in every mode the reference
accepts for the family (the chunk queue preempting mid-prefill and in
decode, the dense prefill on the pool, paging off, the PREFILL/DECODE
pair, finished-sequence offload), the cross rows a park carries back
bitwise, a slot reused by a shorter source keeping its earlier
occupant's rows past the bucket (the reference's behaviour), the
reference's refusals, and a CPU rehearsal of ``chip_smoke.py`` phase
12's settings at the smoke width with the full width's page bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.paging import PagingError as JaxPagingError
from repro.serve import config as jconf
from repro.serve import disagg as jdisagg
from repro.serve import engine as jengine_mod
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.paging import Pager, PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve import disagg as tdisagg
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import extract_aux_slot

ARCH = "seamless-m4t-medium"
TOL = 2e-6
#: prompt lengths (buckets 16, 8, 32, 16, 32, 8 of (8, 16, 32)) and new
#: tokens: on 7 frames of 4 the chunk queue preempts a half-prefilled
#: request and a running one, and slots are reused by shorter sources
LENS, MAX_NEW = (13, 6, 17, 9, 20, 5), 6
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted", "prefills")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these engines run small tensors, and the
    test runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: jitted steps and prefills of the JAX engines, shared between engines
#: of one config (one compile each instead of one an engine)
_JAX_STEPS, _JAX_PREFILLS = {}, {}


def _shared(make):
    """The JAX package's step factory, memoized on its arguments."""
    def factory(cfg, mesh, shape, **kw):
        key = repr((make.__name__, repr(cfg), repr(shape),
                    sorted(kw.items())))
        if key not in _JAX_STEPS:
            _JAX_STEPS[key] = make(cfg, mesh, shape, **kw)
        return _JAX_STEPS[key]
    return factory


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_steps():
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_serve_step", "make_mixed_step"):
            mp.setattr(jengine_mod, name,
                       _shared(getattr(jengine_mod, name)))
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jparams = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(a, b, tol=TOL):
    """Within ``tol`` of the larger of 1 and the reference's largest
    magnitude."""
    b = np.asarray(b, np.float32)
    tol = tol * max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=tol,
                               rtol=TOL)


def _jit(fn, *static):
    """The reference function ``fn`` jitted, ``cfg`` (its second
    argument) and the keywords ``static`` static."""
    return jax.jit(fn, static_argnums=(1,), static_argnames=static)


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(vocab, B, T, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# config, registry, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_matches_reference(which):
    port = (get_config if which == "config" else get_smoke)(ARCH)
    ref = (jax_config if which == "config" else jax_smoke)(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()


def test_registry_is_the_reference_registry():
    """Ten architectures in the reference's order, every one served."""
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    assert all(tmodel.family_ported(get_config(a)) for a in ARCH_IDS)
    with pytest.raises(NotImplementedError):     # dense with experts
        tmodel.init_cache(dataclasses.replace(
            get_smoke("phi4-mini-3.8b"), num_experts=4), 1, 8, device="cpu")


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def test_init_params_tree_matches_reference(setup):
    """The port's own draw has the reference's paths and shapes: the
    encoder's dense layers, the decoder's self / cross / MLP layers,
    ``enc_norm`` and the untied head."""
    jcfg, tcfg, jparams, _ = setup
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(own) == _shapes(jparams)
    assert {"encoder", "decoder", "enc_norm", "lm_head"} <= set(own)


# ---------------------------------------------------------------------------
# the encoder and the model functions
# ---------------------------------------------------------------------------

def test_encode_and_encode_cross_match_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    src = _draw(1, 2, 11, jcfg.d_model)
    _close(tmodel._encode(tparams, tcfg, _t(src)).numpy(),
           _jit(jmodel._encode, "remat")(jparams, jcfg, jnp.asarray(src),
                                         remat="none"))
    jc = _jit(jmodel.encode_cross)(jparams, jcfg, jnp.asarray(src))
    tc = tmodel.encode_cross(tparams, tcfg, _t(src))
    assert set(tc) == set(jc) == {"k", "v", "enc_out"}
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        _close(tc[name].numpy(), jc[name])


@pytest.fixture(scope="module")
def prefilled(setup):
    """Both packages' prefill of the same 2 x 12 prompt over a 10-row
    source, cache for 16 positions."""
    jcfg, tcfg, jparams, tparams = setup
    toks = _tokens(jcfg.vocab_size, 2, 12, 2)
    src = _draw(3, 2, 10, jcfg.d_model)
    jl, jc = _jit(jmodel.prefill, "max_len")(
        jparams, jcfg, {"tokens": jnp.asarray(toks),
                        "src_embeds": jnp.asarray(src)}, max_len=16)
    tl, tc = tmodel.prefill(tparams, tcfg, _t(toks), max_len=16,
                            src_embeds=_t(src))
    return (jl, jc), (tl, tc)


def test_prefill_matches_reference(prefilled):
    """Logits, the decoder's K/V (the compute dtype, as the reference
    keeps them) and the cross state of the source's rows."""
    (jl, jc), (tl, tc) = prefilled
    _close(tl.numpy(), jl)
    for name in ("k", "v"):
        assert tc.kv[name].dtype == torch.float32
        _close(tc.kv[name].numpy(), jc.kv[name])
    for name in ("k", "v", "enc_out"):
        assert tuple(tc.cross[name].shape) == tuple(jc.cross[name].shape)
        _close(tc.cross[name].numpy(), jc.cross[name])
    assert tc.pos.tolist() == [12, 12]


def test_decode_step_matches_reference(setup, prefilled):
    """One step on the dense cache from the reference's prefill: logits
    and the K/V written."""
    jcfg, tcfg, jparams, tparams = setup
    (_, jc), _ = prefilled
    jc = jc._replace(kv=dict(jc.kv, k=jnp.pad(jc.kv["k"], (
        (0, 0), (0, 0), (0, 4), (0, 0), (0, 0))), v=jnp.pad(jc.kv["v"], (
            (0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))))
    tc = tmodel.Cache(kv={k: _t(v) for k, v in jc.kv.items()}, ssm=(),
                      cross={k: _t(v) for k, v in jc.cross.items()},
                      pos=_t(jc.pos))
    nxt = _tokens(jcfg.vocab_size, 2, 1, 4)
    jl, jc2 = _jit(jmodel.decode_step)(jparams, jcfg, jc, jnp.asarray(nxt))
    tl, tc2 = tmodel.decode_step(tparams, tcfg, tc, _t(nxt))
    _close(tl.numpy(), jl)
    _close(tc2.kv["k"].numpy(), jc2.kv["k"])
    assert tc2.pos.tolist() == [13, 13]


def _paged_pair(jcfg, tcfg, B, max_len, n_frames, page, seed):
    """The same paged cache on both sides: f32 pools of random K/V, and a
    cross state of ``max_len`` rows whose rows past each slot's source
    hold other values (zeros, or an earlier occupant's)."""
    jc = jmodel.init_paged_cache(jcfg, B, max_len, n_frames, page)
    shape = tuple(jc.kv["k_pages"].shape)
    kp, vp = _draw(seed, *shape), _draw(seed + 1, *shape)
    cross = {k: _draw(seed + 2 + i, *jc.cross[k].shape)
             for i, k in enumerate(("k", "v", "enc_out"))}
    cross["k"][:, 0, 10:] = 0.0                 # slot 0: zeros past 10 rows
    jc = jc._replace(kv=dict(jc.kv, k_pages=jnp.asarray(kp),
                             v_pages=jnp.asarray(vp)),
                     cross={k: jnp.asarray(v) for k, v in cross.items()})
    tc = tmodel.init_paged_cache(tcfg, B, max_len, n_frames, page,
                                 device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.cross.items()} == \
        {k: tuple(v.shape) for k, v in jc.cross.items()}
    tc = tc._replace(kv=dict(tc.kv, k_pages=_t(kp), v_pages=_t(vp)),
                     cross={k: _t(v) for k, v in cross.items()})
    return jc, tc


def test_paged_decode_step_matches_reference(setup):
    """One paged step: self-attention through the page table, cross
    attention over every one of the slots' ``max_len`` cross rows."""
    jcfg, tcfg, jparams, tparams = setup
    jc, tc = _paged_pair(jcfg, tcfg, 2, 16, 9, 4, 5)
    pt = np.array([[0, 1, 2, 8], [3, 4, 5, 6]], np.int32)
    pos = np.array([9, 14], np.int32)
    jc = jc._replace(kv=dict(jc.kv, page_table=jnp.asarray(pt)),
                     pos=jnp.asarray(pos))
    tc = tc._replace(kv=dict(tc.kv, page_table=_t(pt)), pos=_t(pos))
    nxt = _tokens(jcfg.vocab_size, 2, 1, 6)
    jl, jc2 = _jit(jmodel.decode_step, "impl")(jparams, jcfg, jc,
                                               jnp.asarray(nxt), impl="xla")
    tl, tc2 = tmodel.decode_step(tparams, tcfg, tc, _t(nxt))
    _close(tl.numpy(), jl)
    _close(tc2.kv["k_pages"][:, :-1].numpy(), jc2.kv["k_pages"][:, :-1])


def test_prefill_chunk_matches_reference(setup):
    """One chunk of three rows: slots 2 and 0 with sources of 16 and 8
    rows (``src_len``), at different offsets, and an inert row (length
    0); logits of every row and the pool the chunk wrote."""
    jcfg, tcfg, jparams, tparams = setup
    jc, tc = _paged_pair(jcfg, tcfg, 3, 16, 13, 4, 7)
    chunk = {"tokens": _tokens(jcfg.vocab_size, 3, 5, 8),
             "offset": np.array([0, 4, 0], np.int32),
             "length": np.array([5, 3, 0], np.int32),
             "page_rows": np.array([[0, 1, 12, 12], [2, 3, 12, 12],
                                    [12, 12, 12, 12]], np.int32),
             "slots": np.array([2, 0, 1], np.int32),
             "src_len": np.array([16, 8, 0], np.int32)}
    jl, jc2, _ = _jit(jmodel.prefill_chunk, "impl")(
        jparams, jcfg, jc, {k: jnp.asarray(v) for k, v in chunk.items()},
        impl="xla")
    tl, tc2, carry = tmodel.prefill_chunk(
        tparams, tcfg, tc, {k: _t(v) for k, v in chunk.items()})
    assert carry is None
    _close(tl.numpy(), jl)
    _close(tc2.kv["k_pages"][:, :-1].numpy(), jc2.kv["k_pages"][:, :-1])
    _close(tc2.kv["v_pages"][:, :-1].numpy(), jc2.kv["v_pages"][:, :-1])


def test_cross_helpers_plain_match_reference():
    """The plain versions of the two cross-attention helpers are the
    reference's ``chunked_attention``: the decode's not masked, the
    chunk's on the rows gathered by slot with each row's
    ``kv_valid_len``."""
    B, Ssrc, H, Hkv, D = 3, 20, 4, 2, 16
    k, v = _draw(10, B, Ssrc, Hkv, D), _draw(11, B, Ssrc, Hkv, D)
    ref_attn = jax.jit(jattn.chunked_attention,
                       static_argnames=("causal",))
    q1 = _draw(12, B, 1, H, D)
    _close(tattn.cross_decode_attention(_t(q1), _t(k), _t(v)).numpy(),
           ref_attn(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                    causal=False))
    q = _draw(13, 3, 7, H, D)
    rows = [(2, 20, 7), (0, 5, 3), (1, 0, 0)]
    slots, src_len, _ = (np.array(c) for c in zip(*rows))
    ref = ref_attn(jnp.asarray(q), jnp.asarray(k[slots]),
                   jnp.asarray(v[slots]), causal=False,
                   kv_valid_len=jnp.asarray(src_len, jnp.int32))
    _close(tattn.cross_chunk_attention(_t(q), _t(k), _t(v), rows).numpy(),
           ref)


def test_cross_helpers_never_fall_back():
    """Asked for the kernel, a helper launches or raises: on a CPU
    tensor it raises, it does not run the plain version."""
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.cross_decode_attention(torch.zeros((1, 1, 4, 16)), k, k,
                                     impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.cross_chunk_attention(torch.zeros((1, 3, 4, 16)), k, k,
                                    [(0, 8, 3)], impl="cuda")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _requests(vocab, d_model):
    """The prompts of ``LENS`` and their sources, some shorter than the
    prompt's bucket and some longer (cut to it)."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, n) for n in LENS]
    srcs = [rng.standard_normal((n + (3 if i % 2 else -2), d_model))
            .astype(np.float32) for i, n in enumerate(LENS)]
    return prompts, srcs


def _econf(mod, *, pages=7, chunk=4, enabled=None, role="fused",
           paging=None, **extra):
    pg = dict(enabled=enabled, page_size=4, device_pages=pages,
              hot_tail_pages=1)
    pg.update(paging or {})
    kw = {"device": "cpu"} if mod is tconf else {}
    return mod.EngineConfig(
        max_batch=2, max_len=32, prefill_buckets=(8, 16, 32), role=role,
        paging=mod.PagingConfig(**pg),
        chunking=mod.ChunkingConfig(chunk_tokens=chunk, chunk_slots=2),
        **kw, **extra)


def _jax_engine(cfg, params, econf):
    """A JAX engine whose prefills and encoder runs (keyed by bucket;
    every engine here has one ``max_len``) are shared."""
    eng = JaxEngine(cfg, params, econf)
    eng._prefills = _JAX_PREFILLS
    return eng


def _submit_all(eng, cfg):
    for p, s in zip(*_requests(cfg.vocab_size, cfg.d_model)):
        eng.submit(p, max_new_tokens=MAX_NEW, src_embeds=s)


def _serve(engine_cls, cfg, params, econf, hook=None):
    eng = engine_cls(cfg, params, econf)
    if hook is not None:
        hook(eng)
    _submit_all(eng, cfg)
    return eng, eng.run()


def _watch(eng):
    """Record what the port's engine does with the cross state: every
    running slot's cross rows at its park held bitwise against the rows
    its resume puts back (``eng.resumed``); every ``_install_cross`` (the
    encoder at a chunked admission or a mid-prefill resume) with the
    slot, its bucket, and whether the slot's rows past the bucket held
    non-zero values of an earlier occupant (``eng.installs``)."""
    eng.parked_cross, eng.resumed, eng.installs = {}, 0, []
    park, resume, install = (eng._park, eng._try_finish_resumes,
                             eng._install_cross)

    def parked(req):
        eng.parked_cross[req.rid] = {
            k: t.clone() for k, t in extract_aux_slot(
                eng.cache, req.slot, eng.max_batch)["cross"].items()}
        park(req)

    def resumed():
        waiting = {rid: r for rid, r in eng._resuming.items()
                   if not r.mid_prefill}
        resume()
        for rid, req in waiting.items():
            if rid in eng._resuming:
                continue
            now = extract_aux_slot(eng.cache, req.slot, eng.max_batch)
            for name, t in eng.parked_cross.pop(rid).items():
                assert torch.equal(t, now["cross"][name])
            eng.resumed += 1

    def installed(req):
        install(req)
        stale = bool(eng.cache.cross["k"][:, req.slot, req.src_len:]
                     .abs().sum() > 0)
        eng.installs.append((req.rid, req.slot, req.src_len, stale))
    eng._park, eng._try_finish_resumes = parked, resumed
    eng._install_cross = installed


#: id -> options of both engines: the chunk queue (preempting mid-prefill
#: and in decode), the dense prefill on the pool (preempting), paging off
MODES = {"chunked": {}, "dense-prefill": dict(chunk=None),
         "non-paged": dict(chunk=None, enabled=False)}


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, tcfg, jparams, tparams = setup
    return {mode: (_serve(Engine, tcfg, tparams, _econf(tconf, **kw),
                          hook=_watch if mode == "chunked" else None),
                   _serve(_jax_engine, jcfg, jparams, _econf(jconf, **kw)))
            for mode, kw in MODES.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(engines, mode):
    (teng, tout), (jeng, jout) = engines[mode]
    assert tout == jout
    for key in COUNTERS:
        assert teng.stats[key] == jeng.stats[key], key
    if mode != "non-paged":
        assert teng.stats["preemptions"] > 0 and teng.stats["resumes"] > 0
        assert teng.page_pool.n_free == teng.page_pool.n_pages
    else:
        assert teng.page_pool is None
        assert tuple(teng.cache.cross["k"].shape[1:3]) == (2, 32)


def test_chunk_queue_parks_and_resumes_the_cross_state(engines):
    """The chunk queue preempts a half-prefilled request (its resume
    runs the encoder again: one ``_install_cross`` more than the
    admissions) and a running one (its cross rows come back bitwise)."""
    (eng, _), _ = engines["chunked"]
    st = eng.stats
    assert st["prefill_preempts"] > 0
    assert st["preemptions"] - st["prefill_preempts"] > 0
    assert eng.resumed == st["preemptions"] - st["prefill_preempts"]
    assert len(eng.installs) == len(LENS) + st["prefill_preempts"]


def test_stale_cross_rows_past_a_shorter_bucket(engines):
    """A slot reused by a request whose bucket is shorter than an
    earlier occupant's keeps that occupant's cross rows past the bucket,
    and the decode reads them unmasked: the reference's behaviour, which
    the tokens above equal."""
    (eng, _), _ = engines["chunked"]
    first = {}
    shorter = []
    for rid, slot, bucket, stale in eng.installs:
        if slot in first and bucket < first[slot]:
            shorter.append(stale)
        first[slot] = max(first.get(slot, 0), bucket)
    assert shorter and all(shorter)


def test_roles_match_jax_pair(setup, engines):
    """The PREFILL/DECODE pair over one shared tier: the residue carries
    the cross state through the tier and the record its ``src_len``; the
    pair gives the JAX pair's tokens."""
    jcfg, tcfg, jparams, tparams = setup
    outs, recs = {}, []
    for mod, dis, cls, cfg, params in (
            (tconf, tdisagg, Engine, tcfg, tparams),
            (jconf, jdisagg, _jax_engine, jcfg, jparams)):
        tier = dis.make_shared_tier()
        mk = dis.tier_pager_factory(tier)
        kw = dict(paging={"pager_factory": mk})
        pe = cls(cfg, params, _econf(mod, role="prefill", **kw))
        de = cls(cfg, params, _econf(mod, role="decode",
                                     handoff=pe.handoff, **kw))
        if mod is tconf:
            publish = pe.handoff.publish
            pe.handoff.publish = lambda rec: (recs.append(rec),
                                              publish(rec))
        _submit_all(pe, cfg)
        outs[mod] = dis.run_disaggregated(pe, de)
        assert pe.stats["handoffs"] == len(LENS)
    assert outs[tconf] == outs[jconf]
    assert sorted(r.src_len for r in recs) == sorted([8, 8, 16, 16, 32, 32])


def test_offload_finished_carries_the_cross_state(setup):
    """With finished-sequence offload the tokens are the JAX engine's; a
    finished sequence's far-tier entry holds its cross state, every
    ``max_len`` row, and ``fetch_finished`` returns it with the K/V."""
    jcfg, tcfg, jparams, tparams = setup
    eng, out = _serve(Engine, tcfg, tparams, _econf(
        tconf, paging={"offload_finished": True}))
    _, jout = _serve(_jax_engine, jcfg, jparams, _econf(
        jconf, paging={"offload_finished": True}))
    assert out == jout
    cache = eng.fetch_finished(0)
    L, hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    assert tuple(cache.cross["k"].shape) == (L, 1, 32, hkv, hd)
    assert tuple(cache.cross["enc_out"].shape) == (1, 32, tcfg.d_model)
    assert tuple(cache.kv["k"].shape) == (L, 1, 32, hkv, hd)
    assert bool(cache.cross["k"][:, :, :16].abs().sum() > 0)


@pytest.mark.parametrize("change", [
    dict(paging={"kv_quant": "int8"}),
    dict(prefix_cache=True),
    dict(speculate_k=2),
])
def test_engine_refusals_match_reference(setup, change):
    """What the reference refuses for the family raises its
    ``PagingError`` in both engines: a quantized pool, the prefix cache,
    speculation."""
    jcfg, tcfg, _, _ = setup
    for mod, cls, cfg, err in ((tconf, Engine, tcfg, PagingError),
                               (jconf, JaxEngine, jcfg, JaxPagingError)):
        kw, extra = dict(change), {}
        if kw.pop("prefix_cache", False):
            extra["chunking"] = mod.ChunkingConfig(chunk_tokens=4,
                                                   prefix_cache=True)
        if "speculate_k" in kw:
            extra["speculation"] = mod.SpeculationConfig(
                speculate_k=kw.pop("speculate_k"))
        econf = dataclasses.replace(_econf(mod, **kw), **extra)
        with pytest.raises(err):
            cls(cfg, {}, econf)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12's settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["12a", "12e"])
def test_chip_smoke_encdec_settings_preempt_and_resume(tag):
    """``chip_smoke.py`` phase 12 (a)'s and (e)'s settings: phase 3's
    engine on 448 and on ``ENCDEC_TIGHT_PAGES`` frames, seamless-m4t-
    medium's full-width page bytes (786,432: 16 positions of 12 decoder
    layers, K and V, 16 x 64 in bf16), phase 12's prompts and their
    sources.  Scheduling reads shapes and page bytes only, so one layer
    of the smoke width (one head) makes the card run's decisions: the
    chunk queue preempts half-prefilled requests (their encoder runs
    again, into the same rows) and, in (e), a running slot (its cross
    rows parked and put back bitwise), with the counts the card run
    repeats (``chip_smoke.watch_cross`` holds each resume)."""
    import chip_smoke

    full = get_config(ARCH)
    nbytes = (2 * tmodel.kv_layers(full) * chip_smoke.ENGINE["page_size"]
              * full.num_kv_heads * full.head_dim * 2)
    assert nbytes == chip_smoke.ENCDEC_FRAME == 786_432

    def pager_factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=nbytes)

    pages = {"12a": chip_smoke.ENGINE["device_pages"],
             "12e": chip_smoke.ENCDEC_TIGHT_PAGES}[tag]
    cfg = dataclasses.replace(get_smoke(ARCH), num_layers=1,
                              encoder_layers=1, num_heads=1, num_kv_heads=1)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, chip_smoke.engine_config(
        "cpu", pages, pager_factory=pager_factory))
    seen = {}
    chip_smoke.watch_cross(eng, seen)
    ps, srcs = chip_smoke.encdec_requests(cfg.d_model)
    assert [len(s) for s in srcs] == [len(p) for p in ps]
    for p, s in zip(ps, srcs):
        eng.submit(p % cfg.vocab_size, max_new_tokens=chip_smoke.NEW_TOKENS,
                   src_embeds=s)
    out = eng.run()
    assert len(out) == chip_smoke.N_REQUESTS
    assert all(len(v) == chip_smoke.NEW_TOKENS for v in out.values())
    counts = chip_smoke.ENCDEC_COUNTS[tag]
    assert {k: eng.stats[k] for k in counts} == counts
    running = counts["preemptions"] - counts["prefill_preempts"]
    assert (running > 0) == (tag == "12e")
    assert seen["slot"] == running
    assert seen["encoded_again"] == counts["prefill_preempts"] > 0
    assert seen["encodes"] == chip_smoke.N_REQUESTS + counts["prefill_preempts"]
