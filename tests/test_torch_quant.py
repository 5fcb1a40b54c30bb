"""The int8 / fp8 quantized page pool of the port against the JAX package.

Every input is numpy-seeded and goes through both packages:

* the port's ``kernels/kv_quant.py`` against the JAX package's, under
  ``jax.jit`` as the JAX engine runs it (XLA turns ``rowmax / qmax`` into
  ``rowmax * (1 / qmax)``, which the port computes too): pages byte-equal
  (compared as ``uint8``), scales bitwise, for row-0 reset, monotone
  growth and untouched frames; the port requantizes only the frames a
  window can write, and its pool equals the JAX package's rewrite of
  every frame of ``page_rows`` everywhere but the trash frame (junk that
  no read sees);
* the plain quantized versions of the three paged kernels against the
  JAX package's ``kernels.ops`` on its XLA path and its Pallas kernels in
  interpret mode, within 2e-5 (the reference's own quantized bar,
  ``tests/test_kv_quant.py``), with pages that straddle and unused table
  entries on the trash frame;
* the cache layout and page bytes of both engines;
* the port's quantized engine, plain and speculative, against the JAX
  quantized engine on bridged f32 SMOKE weights under preemption: the
  same greedy tokens and counters; inside the port, the preempting
  engine's tokens against a roomy one's, and the scales riding park and
  resume as bytes.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels import kv_quant as jq
from repro.kernels import ops as jops
from repro.models import init_params as jax_init_params
from repro.serve import config as jconf
from repro.serve import engine as jengine_mod
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.kernels import kv_quant as tq
from repro_torch.kernels import ops
from repro_torch.paging import PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine

MODES = ("int8", "fp8")
TORCH_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
N, PAGE, HKV, D, H = 9, 4, 2, 16, 6          # G = 3, trash frame N - 1
TOL = 2e-5


def _to_torch(a, mode):
    """A JAX int8/fp8 array as a torch tensor of the same bytes."""
    raw = np.asarray(a).view(np.uint8).copy()
    return torch.from_numpy(raw).view(TORCH_DTYPE[mode])


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _quant_pool(rng, mode, n=N):
    """A quantized pool with consistent absmax scales, (n, PAGE, HKV, D)
    in JAX and in torch, and its scales."""
    q = jq.KVQuantConfig(mode)
    x = rng.standard_normal((n, PAGE, HKV, D)).astype(np.float32) * 2
    s = (np.abs(x).max(axis=(1, 3)) / np.float32(q.qmax)).astype(np.float32)
    jp = jq.quantize(jnp.asarray(x), jnp.asarray(s)[:, None, :, None], q)
    return jp, _to_torch(jp, mode), s


# ---------------------------------------------------------------------------
# kv_quant ops
# ---------------------------------------------------------------------------

def test_config_modes_match_jax():
    for mode in ("none", "int8", "fp8"):
        t, j = tq.KVQuantConfig(mode), jq.KVQuantConfig(mode)
        assert (t.enabled, t.qmax) == (j.enabled, j.qmax)
        assert t.itemsize == j.itemsize
        assert tq.KVQuantConfig.from_dtype(t.dtype) == t
    assert tq.KVQuantConfig.from_name(None).mode == "none"
    assert tq.KVQuantConfig("fp8").dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="kv_quant mode"):
        tq.KVQuantConfig("int4")


@pytest.mark.parametrize("mode", MODES)
def test_quantize_dequantize_requant_match_jax(mode):
    """Bytes of ``quantize`` and ``requant`` (ratio 1 a no-op, ratio 0
    zeros, ratios in between), values of ``dequantize``."""
    rng = np.random.default_rng(0)
    jqc, tqc = jq.KVQuantConfig(mode), tq.KVQuantConfig(mode)
    jp, tp, s = _quant_pool(rng, mode)
    x = rng.standard_normal((N, PAGE, HKV, D)).astype(np.float32) * 2
    s4 = s[:, None, :, None]
    np.testing.assert_array_equal(
        _bytes(tq.quantize(torch.from_numpy(x), torch.from_numpy(s4), tqc)),
        _bytes(jq.quantize(jnp.asarray(x), jnp.asarray(s4), jqc)))
    np.testing.assert_array_equal(
        tq.dequantize(tp, torch.from_numpy(s4)).numpy(),
        np.asarray(jq.dequantize(jp, jnp.asarray(s4))))
    ratio = np.concatenate([[1.0, 0.0], rng.uniform(0, 1, N - 2)]).astype(
        np.float32)[:, None, None, None]
    jr = jax.jit(lambda p, r: jq.requant(p, r, jqc))(jp, jnp.asarray(ratio))
    tr = tq.requant(tp, torch.from_numpy(ratio), tqc)
    np.testing.assert_array_equal(_bytes(tr), _bytes(jr))
    np.testing.assert_array_equal(_bytes(tr)[0], _bytes(tp)[0])  # ratio 1
    assert torch.all(tr[1].float() == 0)                         # ratio 0


@pytest.mark.parametrize("mode", MODES)
def test_scatter_token_matches_jitted_jax(mode):
    """Five decode steps over three live slots and an empty one (trash):
    row 0 on a frame with junk from a past life resets scale and content,
    later rows only raise the scale (a large token, then a small one)."""
    rng = np.random.default_rng(1)
    jqc, tqc = jq.KVQuantConfig(mode), tq.KVQuantConfig(mode)
    jp, tp, s = _quant_pool(rng, mode)
    js, ts = jnp.asarray(s), torch.from_numpy(s.copy())
    orig = _bytes(tp).copy()
    step = jax.jit(lambda p, sc, n, f, r: jq.quant_scatter_token(
        p, sc, n, f, r, jqc))
    frame = np.array([2, 5, 7, N - 1], np.int32)
    for i, (rows, mag) in enumerate([([0, 2, 3, 1], 1.0), ([1, 3, 0, 2], 4.0),
                                     ([2, 0, 1, 3], 0.25), ([3, 1, 2, 0], 1.0),
                                     ([0, 2, 3, 1], 0.5)]):
        new = (rng.standard_normal((4, HKV, D)) * mag).astype(np.float32)
        row = np.array(rows, np.int32)
        before = ts.clone()
        jp, js = step(jp, js, jnp.asarray(new), jnp.asarray(frame),
                      jnp.asarray(row))
        tq.quant_scatter_token(tp, ts, torch.from_numpy(new),
                               torch.from_numpy(frame), torch.from_numpy(row),
                               tqc)
        np.testing.assert_array_equal(_bytes(tp)[:-1], _bytes(jp)[:-1])
        np.testing.assert_array_equal(ts.numpy()[:-1], np.asarray(js)[:-1])
        live = torch.from_numpy(frame[:3]).long()
        start = torch.from_numpy(row[:3] == 0)[:, None]
        grown = ts[live] >= before[live]
        assert torch.all(start | grown), i          # monotone off row 0
    untouched = [f for f in range(N - 1) if f not in frame]
    np.testing.assert_array_equal(_bytes(tp)[untouched], orig[untouched])


def _window(offset, length, T, pps, page_rows, trash=N - 1):
    """The (page_idx, row, ok, frame_tok) a prefill / verify block builds
    for rows starting at ``offset`` with ``length`` valid tokens."""
    abs_pos = offset[:, None] + np.arange(T)[None, :]
    ok = (np.arange(T)[None, :] < length[:, None]) & (abs_pos < pps * PAGE)
    page_idx = np.clip(abs_pos // PAGE, 0, pps - 1).astype(np.int32)
    frame = np.where(ok, np.take_along_axis(page_rows, page_idx, 1), trash)
    return page_idx, (abs_pos % PAGE).astype(np.int32), ok, \
        frame.astype(np.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["prefill", "verify"])
def test_scatter_multi_matches_jitted_jax_full_rewrite(mode, case):
    """Windows starting mid-page, on a page edge and at 0, one running
    past the row's capacity, an inert row: the port's pool (only the
    window's frames requantized) equals the JAX package's (every frame of
    ``page_rows`` rewritten) byte for byte, scales bitwise, trash frame
    aside; frames outside the windows keep their bytes."""
    rng = np.random.default_rng(2 if case == "prefill" else 3)
    jqc, tqc = jq.KVQuantConfig(mode), tq.KVQuantConfig(mode)
    jp, tp, s = _quant_pool(rng, mode, n=17)
    trash = 16
    pps = 4
    if case == "prefill":
        T = 6
        offset = np.array([5, 0, 4, 0], np.int32)
        length = np.array([6, 3, 6, 0], np.int32)
    else:
        T = 5
        offset = np.array([3, 12, 0, 8], np.int32)
        length = np.array([5, 5, 2, 0], np.int32)
    page_rows = np.full((4, pps), trash, np.int32)
    perm = rng.permutation(trash)
    for c in range(4):
        used = -(-int(min(offset[c] + max(length[c], 1), pps * PAGE))
                 // PAGE)
        page_rows[c, :used] = perm[c * pps:c * pps + used]
    page_idx, row, ok, frame = _window(offset, length, T, pps, page_rows,
                                       trash)
    new = rng.standard_normal((4, T, HKV, D)).astype(np.float32) * 3
    js, ts = jnp.asarray(s), torch.from_numpy(s.copy())
    before = _bytes(tp).copy()
    jp2, js2 = jax.jit(lambda *a: jq.quant_scatter_multi(*a, jqc))(
        jp, js, jnp.asarray(new), jnp.asarray(page_rows),
        jnp.asarray(page_idx), jnp.asarray(row), jnp.asarray(ok),
        jnp.asarray(frame))
    tq.quant_scatter_multi(tp, ts, torch.from_numpy(new),
                           torch.from_numpy(page_rows),
                           torch.from_numpy(page_idx), torch.from_numpy(row),
                           torch.from_numpy(ok), torch.from_numpy(frame), tqc)
    np.testing.assert_array_equal(_bytes(tp)[:trash], _bytes(jp2)[:trash])
    np.testing.assert_array_equal(ts.numpy()[:trash],
                                  np.asarray(js2)[:trash])
    written = set(frame[ok].tolist())
    for f in range(trash):
        if f not in written:
            np.testing.assert_array_equal(_bytes(tp)[f], before[f])
            assert np.array_equal(ts.numpy()[f], s[f])
    assert written, "no frame written"


@pytest.mark.parametrize("mode", MODES)
def test_scatter_multi_row0_reset_and_growth(mode):
    """A window that starts a page zeroes the frame's junk and resets its
    scale; a later window on the same frame only raises it, and the rows
    already stored stay readable (the JAX package's unit checks,
    ``tests/test_kv_quant.py``)."""
    qcfg = tq.KVQuantConfig(mode)
    pages = torch.full((3, PAGE, HKV, D), 99.0).to(qcfg.dtype)  # past life
    scales = torch.full((3, HKV), 7.0)
    rows = torch.tensor([[0, 1]], dtype=torch.int32)

    def put(vals, pos):
        T = len(vals)
        new = torch.tensor(vals, dtype=torch.float32)
        new = new[None, :, None, None].expand(1, T, HKV, D)
        ap = torch.arange(pos, pos + T, dtype=torch.int32)[None]
        tq.quant_scatter_multi(pages, scales, new, rows, ap // PAGE,
                               ap % PAGE, torch.ones(1, T, dtype=torch.bool),
                               rows[0][ap // PAGE].to(torch.int32), qcfg)

    put([0.5, 0.25], 0)
    assert torch.allclose(scales[0], torch.tensor(0.5 / qcfg.qmax))
    deq = tq.dequantize(pages[0], scales[0][None, :, None])
    assert torch.all(deq[2:] == 0)                              # junk gone
    put([2.0], 2)
    assert torch.allclose(scales[0], torch.tensor(2.0 / qcfg.qmax))
    deq = tq.dequantize(pages[0], scales[0][None, :, None])
    torch.testing.assert_close(deq[:3, 0, 0], torch.tensor([0.5, 0.25, 2.0]),
                               rtol=0.1, atol=0.02)
    put([0.1], 3)
    assert torch.allclose(scales[0], torch.tensor(2.0 / qcfg.qmax))


# ---------------------------------------------------------------------------
# plain quantized kernels vs the JAX package's ops
# ---------------------------------------------------------------------------

def _table(rng, rows_len, pps):
    table = np.full((len(rows_len), pps), N - 1, np.int32)
    for b, n in enumerate(rows_len):
        used = -(-int(n) // PAGE)
        table[b, :used] = rng.permutation(N - 1)[:used]
    return table


def _quant_operands(rng, mode):
    jk, tk, ks = _quant_pool(rng, mode)
    jv, tv, vs = _quant_pool(rng, mode)
    return (jk, jv, jnp.asarray(ks), jnp.asarray(vs)), \
        (tk, tv, torch.from_numpy(ks), torch.from_numpy(vs))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_decode_plain_matches_jax(impl, mode):
    rng = np.random.default_rng(4)
    lengths = np.array([1, 4, 5, 13, 20], np.int32)
    pt = _table(rng, lengths, 5)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quant_operands(rng, mode)
    q = rng.standard_normal((len(lengths), H, D)).astype(np.float32)
    ref = jops.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lengths),
        impl=impl, k_scales=jks, v_scales=jvs)
    out = ops.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lengths), k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_verify_plain_matches_jax(impl, mode):
    rng = np.random.default_rng(5)
    S = 3
    base = np.array([1, 3, 4, 14], np.int32)
    lengths = (base[:, None] + np.arange(S)[None, :]).astype(np.int32)
    pt = _table(rng, lengths[:, -1], 5)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quant_operands(rng, mode)
    q = rng.standard_normal((len(base), S, H, D)).astype(np.float32)
    ref = jops.paged_verify_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lengths),
        impl=impl, k_scales=jks, v_scales=jvs)
    out = ops.paged_verify_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lengths), k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_prefill_plain_matches_jax(impl, mode):
    rng = np.random.default_rng(6)
    C, T, pps = 3, 8, 6
    offset = np.array([8, 0, 3], np.int32)
    length = np.array([8, 5, 6], np.int32)
    rows = _table(rng, offset + length, pps)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quant_operands(rng, mode)
    q = rng.standard_normal((C, T, H, D)).astype(np.float32)
    ref = np.asarray(jops.paged_prefill_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(rows), jnp.asarray(offset),
        jnp.asarray(length), impl=impl, k_scales=jks, v_scales=jvs))
    out = ops.paged_prefill_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(rows),
        torch.from_numpy(offset), torch.from_numpy(length),
        k_scales=tks, v_scales=tvs)
    for c, n in enumerate(length):
        np.testing.assert_allclose(out[c, :n].numpy(), ref[c, :n], atol=TOL,
                                   rtol=TOL)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

LENGTHS = [13, 6, 17, 9, 20, 5]
MAX_NEW = 7
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted")
SPEC_COUNTERS = ("steps", "mixed_steps", "spec_steps", "drafted",
                 "accepted", "rejected", "preemptions", "resumes")
K = 4


def _econf(mod, mode, device_pages=9, speculate_k=0, factory=None,
           **extra):
    return mod.EngineConfig(
        max_batch=3, max_len=32,
        paging=mod.PagingConfig(page_size=4, device_pages=device_pages,
                                hot_tail_pages=1, kv_quant=mode),
        chunking=mod.ChunkingConfig(chunk_tokens=8, chunk_slots=2),
        speculation=mod.SpeculationConfig(speculate_k=speculate_k,
                                          speculate_ngram=2,
                                          proposer_factory=factory),
        **extra)


def _serve(engine_cls, cfg, params, econf, prompts, wrap=None):
    eng = engine_cls(cfg, params, econf)
    if wrap:
        wrap(eng)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    return eng, eng.run()


class _Oracle:
    """Drafts a reference run's continuation."""

    def __init__(self, refs, prompt_lens, k):
        self.refs, self.prompt_lens, self.k = refs, prompt_lens, k

    def propose(self, rid, history):
        n = len(history) - self.prompt_lens[rid]
        return list(self.refs[rid][n:n + self.k])

    def drop(self, rid):
        pass


class _Wrong(_Oracle):
    """Reference token + 1: rejected at row 0."""

    def __init__(self, refs, prompt_lens, k, vocab):
        super().__init__(refs, prompt_lens, k)
        self.vocab = vocab

    def propose(self, rid, history):
        return [(t + 1) % self.vocab for t in super().propose(rid, history)]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in LENGTHS]
    return jcfg, tcfg, jparams, tparams, prompts


def _record_transfers(eng):
    """Keep a copy of every payload read for the far tier, and on each
    landing record whether the frame's bytes and scales in the pool now
    equal that payload's at the moment it was read."""
    eng.parked, eng.landings = {}, []
    read, land = eng._read_frame, eng._land_frame

    def read_frame(phys):
        data = read(phys)
        eng.parked[id(data)] = (data, {k: v.clone() for k, v in data.items()})
        return data

    def land_frame(phys):
        data = eng.page_pool.frames[phys].data
        land(phys)
        if data is not None:
            _, at_park = eng.parked[id(data)]
            now = eng._frame_views(phys)
            eng.landings.append(all(torch.equal(now[k].cpu(), v)
                                    for k, v in at_park.items()))

    eng._read_frame = eng.pager.read_frame = read_frame
    eng._land_frame = land_frame


#: jitted steps of the JAX engines, shared between engines of one config
_JAX_STEPS = {}


def _shared(make):
    """The JAX package's step factory, memoized on its arguments: engines
    of one config run one jitted program (compiled once per dtype)
    instead of compiling their own copy of it."""
    def factory(cfg, mesh, shape, **kw):
        key = (make.__name__, repr(cfg), repr(shape), sorted(kw.items()))
        key = repr(key)
        if key not in _JAX_STEPS:
            _JAX_STEPS[key] = make(cfg, mesh, shape, **kw)
        return _JAX_STEPS[key]
    return factory


@pytest.fixture(scope="module", params=MODES)
def engines(request, weights):
    """Per mode: the port's and the JAX package's quantized engines, plain
    and speculative (oracle and never-matching drafts), on a pool that
    preempts; and the port's roomy quantized engine."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_serve_step", "make_mixed_step"):
            mp.setattr(jengine_mod, name, _shared(getattr(jengine_mod, name)))
        return _engines(request.param, weights)


def _engines(mode, weights):
    jcfg, tcfg, jparams, tparams, prompts = weights
    port, pout = _serve(Engine, tcfg, tparams,
                        _econf(tconf, mode, device="cpu"), prompts,
                        wrap=_record_transfers)
    jeng, jout = _serve(JaxEngine, jcfg, jparams, _econf(jconf, mode),
                        prompts)
    roomy = _serve(Engine, tcfg, tparams,
                   _econf(tconf, mode, None, device="cpu"), prompts)
    lens = {i: len(p) for i, p in enumerate(prompts)}
    spec = {}
    factories = {
        "oracle": lambda n, k: _Oracle(pout, lens, k),
        "wrong": lambda n, k: _Wrong(pout, lens, k, tcfg.vocab_size)}
    for kind, fac in factories.items():
        spec[kind] = (
            _serve(Engine, tcfg, tparams,
                   _econf(tconf, mode, speculate_k=K, factory=fac,
                          device="cpu"), prompts),
            _serve(JaxEngine, jcfg, jparams,
                   _econf(jconf, mode, speculate_k=K, factory=fac), prompts))
    return mode, (port, pout), (jeng, jout), roomy, spec


def test_quant_engine_matches_jax_quant_engine(engines):
    mode, (port, pout), (jeng, jout), _, _ = engines
    assert port.cache.kv["k_pages"].dtype == TORCH_DTYPE[mode]
    assert jeng.stats["preemptions"] > 0 and jeng.stats["resumes"] > 0
    assert sorted(pout) == list(range(len(LENGTHS)))
    assert all(len(v) == MAX_NEW for v in pout.values())
    assert pout == jout
    assert {c: port.stats[c] for c in COUNTERS} == \
        {c: jeng.stats[c] for c in COUNTERS}
    assert dict(port.pager.stats) == dict(jeng.pager.stats)


@pytest.mark.parametrize("kind", ["oracle", "wrong"])
def test_quant_spec_engine_matches_jax_quant_spec_engine(engines, kind):
    """Speculative runs leave scales where rejected drafts raised them,
    in both packages: the port's spec stream is the JAX spec stream."""
    _, _, _, _, spec = engines
    (teng, tout), (jeng, jout) = spec[kind]
    assert tout == jout
    assert {c: teng.stats[c] for c in SPEC_COUNTERS} == \
        {c: jeng.stats[c] for c in SPEC_COUNTERS}
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)
    teng.check_invariants()
    assert teng.stats["spec_steps"] > 0
    if kind == "wrong":
        assert teng.stats["accepted"] == 0
        assert teng.stats["preemptions"] > 0 and teng.stats["resumes"] > 0


def test_preempting_quant_engine_matches_roomy_one(engines):
    """Parks and resumes move quantized bytes and scales verbatim, so the
    churning engine's tokens are a roomy engine's."""
    _, (port, pout), _, (roomy, rout), _ = engines
    assert roomy.stats["preemptions"] == 0 and port.stats["preemptions"] > 0
    assert rout == pout
    assert port.page_pool.n_free == port.page_pool.n_pages


def test_parked_scales_return_with_resume(engines):
    """Every payload the pager parked carried the frame's (L, Hkv) f32
    scales beside its bytes, and every resume that landed one restored
    bytes and scales exactly as they were parked."""
    _, (port, _), _, _, _ = engines
    L, hkv = port.cfg.num_layers, port.cfg.num_kv_heads
    assert port.parked
    for _, at_park in port.parked.values():
        assert set(at_park) == {"k", "v", "k_scale", "v_scale"}
        assert at_park["k_scale"].shape == (L, hkv)
        assert at_park["k_scale"].dtype == torch.float32
        assert at_park["k"].dtype == torch.uint8
    assert port.landings and all(port.landings)


def test_none_mode_cache_has_no_scales_and_bf16_pool(weights):
    jcfg, tcfg, jparams, tparams, _ = weights
    eng = Engine(tcfg, tparams, _econf(tconf, "none", device="cpu"))
    jeng = JaxEngine(jcfg, jparams, _econf(jconf, "none"))
    assert set(eng.cache.kv) == {"k_pages", "v_pages", "page_table"}
    assert eng.cache.kv["k_pages"].dtype == torch.bfloat16
    assert eng.pager.page_nbytes == jeng.pager.page_nbytes


@pytest.mark.parametrize("mode", MODES)
def test_quant_cache_layout_and_page_bytes_match_jax(weights, mode):
    jcfg, tcfg, jparams, tparams, _ = weights
    eng = Engine(tcfg, tparams, _econf(tconf, mode, device="cpu"))
    jeng = JaxEngine(jcfg, jparams, _econf(jconf, mode))
    kv = eng.cache.kv
    L, n, page, hkv, d = kv["k_pages"].shape
    assert n == 9 + 1                                # pool + trash frame
    assert kv["k_pages"].dtype == kv["v_pages"].dtype == TORCH_DTYPE[mode]
    for key in ("k_scales", "v_scales"):
        assert kv[key].shape == (L, n, hkv) and kv[key].dtype == torch.float32
        assert tuple(kv[key].shape) == tuple(jeng.cache.kv[key].shape)
    assert eng.pager.page_nbytes == jeng.pager.page_nbytes == \
        2 * L * page * hkv * d + 2 * L * hkv * 4


def test_quant_requires_the_paged_engine(weights):
    """The JAX engine's rule, checked before the port's own refusal of the
    dense per-slot path: PagingError, not NotImplementedError."""
    _, tcfg, _, _, _ = weights
    econf = tconf.EngineConfig(device="cpu", paging=tconf.PagingConfig(
        enabled=False, kv_quant="int8"))
    with pytest.raises(PagingError, match="paged engine"):
        Engine(tcfg, {}, econf)


def test_quant_rejects_swa(weights):
    _, tcfg, _, _, _ = weights
    swa = dataclasses.replace(tcfg, attention="swa", window=8)
    with pytest.raises(PagingError, match="swa|SWA|global"):
        Engine(swa, {}, _econf(tconf, "fp8", device="cpu"))


def test_kv_quant_cli_roundtrip():
    ap = argparse.ArgumentParser()
    tconf.add_config_args(ap)
    for mode in ("none", "int8", "fp8"):
        econf = tconf.config_from_args(ap.parse_args(["--kv-quant", mode]))
        assert econf.paging.kv_quant == mode
    with pytest.raises(SystemExit):
        ap.parse_args(["--kv-quant", "int4"])


def test_chip_smoke_quant_settings_preempt_and_resume():
    """``chip_smoke.py``'s full-width engine settings with the int8 pool
    (448 frames of the quantized frame's full-width bytes) preempt and
    resume, plainly and with never-matching drafts.  Scheduling reads
    only shapes and the pager's page bytes, so one smoke-width layer makes
    the decisions the card run makes."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.paging import Pager

    full = get_config("phi4-mini-3.8b")
    L, hkv = full.num_layers, full.num_kv_heads
    nbytes = (2 * L * chip_smoke.ENGINE["page_size"] * hkv * full.head_dim
              + 2 * L * hkv * 4)

    def pager_factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=nbytes)

    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), num_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plens = {i: len(p) for i, p in
             enumerate(chip_smoke.prompts(cfg.vocab_size))}
    out = None
    for spec in (False, True):
        factory = (lambda n, k: chip_smoke.WrongProposer(
            out, plens, k, cfg.padded_vocab)) if spec else None
        econf = chip_smoke.engine_config(
            "cpu", chip_smoke.ENGINE["device_pages"],
            proposer_factory=factory, kv_quant="int8")
        econf = dataclasses.replace(econf, paging=dataclasses.replace(
            econf.paging, pager_factory=pager_factory))
        eng = Engine(cfg, params, econf)
        for p in chip_smoke.prompts(cfg.vocab_size):
            eng.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
        got = eng.run()
        assert len(got) == chip_smoke.N_REQUESTS
        assert all(len(v) == chip_smoke.NEW_TOKENS for v in got.values())
        assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
        ps = eng.pager.stats
        assert ps["bytes_moved_bulk"] == ps["writeback"] * nbytes > 0
        out = out or got
