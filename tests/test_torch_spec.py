"""Speculative verify-K decode in the port against the JAX package.

Kernel, block, step and engine levels on the CPU, on the ``phi4-mini-3.8b``
SMOKE config with f32 compute and weights made by the JAX ``init_params``
and moved over by ``repro_torch.bridge``; every input is numpy-seeded.

* The plain ``paged_verify_attention`` matches the JAX package's XLA path
  and its Pallas kernel in interpret mode at 1e-5 (the reference's own
  interpret-vs-XLA bar, ``tests/test_spec_decode.py``), on rows with
  ``lengths >= 1``; a length-0 row (uniform average on both plain paths,
  zeros from a kernel) is compared with the XLA path only.
* Blocks and steps match the JAX package at 1e-5 on f32 pools, as in
  ``tests/test_torch_model.py``.
* Inside the port, verify row s of the attention is bitwise the one-token
  attention — the property speculative token-exactness rests on, which
  the JAX package's batched form loses on this toolchain; a whole verify
  step's row s is within 1e-5 of the s-th sequential decode step, with
  the same argmax (the CPU BLAS rounds matmuls of different row counts
  differently), and the spec engine's tokens equal the plain engine's.
* The port's spec engine gives the JAX spec engine's tokens and counters
  for every proposer kind, under preemption, with drafts that straddle
  pages (page 4, K = 4); and it gives the port's own plain engine's
  tokens.
"""

import dataclasses
import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serve import config as jconf
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.kernels.decode_attention import (multi_token_attention,
                                                one_token_attention)
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serve import config as tconf
from repro_torch.serve import speculate
from repro_torch.serve.engine import Engine
from repro_torch.serve.speculate import NgramProposer, ngram_key

ATOL = RTOL = 1e-5
K = 4
SPEC_COUNTERS = ("steps", "mixed_steps", "spec_steps", "drafted",
                 "accepted", "rejected", "preemptions", "resumes",
                 "chunks", "admitted")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

def _verify_inputs(pool_dtype):
    """The shapes of ``tests/test_spec_decode.py``'s interpret-vs-XLA
    case (B=2, S=4, Hkv=2, G=4, D=32, page 16, 3 pages per sequence,
    permuted frames, row lengths straddling pages) plus a third sequence
    whose first row has length 0."""
    rng = np.random.default_rng(5)
    B, S, Hkv, G, D, page, per_seq = 3, 4, 2, 4, 32, 16, 3
    N = B * per_seq + 2
    q = rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32)
    kp = rng.standard_normal((N, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N, page, Hkv, D)).astype(np.float32)
    if pool_dtype == "bfloat16":        # the engine's pool dtype; round once
        kp = np.array(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
        vp = np.array(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    pt = rng.permutation(N)[:B * per_seq].reshape(B, per_seq).astype(np.int32)
    slots = per_seq * page
    base = np.array([13, 30], np.int32)
    lengths = np.minimum(base[:, None] + np.arange(S)[None, :] + 1, slots)
    lengths = np.concatenate([lengths, [[0, 1, 16, 17]]]).astype(np.int32)
    return q, kp, vp, pt, lengths


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_verify_plain_matches_jax(impl, pool_dtype):
    q, kp, vp, pt, lengths = _verify_inputs(pool_dtype)
    dt_j, dt_t = getattr(jnp, pool_dtype), getattr(torch, pool_dtype)
    ref = np.asarray(jops.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp, dt_j), jnp.asarray(vp, dt_j),
        jnp.asarray(pt), jnp.asarray(lengths), impl=impl))
    out = ops.paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(kp).to(dt_t),
        torch.from_numpy(vp).to(dt_t), torch.from_numpy(pt),
        torch.from_numpy(lengths))
    assert out.dtype == torch.float32 and out.shape == q.shape
    live = lengths >= 1 if impl == "interpret" else np.ones_like(lengths,
                                                                  bool)
    assert (~live).sum() == (impl == "interpret")
    _close(ref[live], out.numpy()[live])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_token_rows_bitwise_one_token(dtype):
    rng = np.random.default_rng(6)
    B, S, Hkv, G, D, Skv = 3, 5, 2, 3, 16, 40
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv * G, D))).to(dtype)
    kc = torch.from_numpy(rng.standard_normal((B, Skv, Hkv, D))).to(dtype)
    vc = torch.from_numpy(rng.standard_normal((B, Skv, Hkv, D))).to(dtype)
    valid = torch.from_numpy(rng.integers(1, Skv + 1, (B, S)))
    multi = multi_token_attention(q, kc, vc, valid, Hkv)
    assert multi.shape == (B, S, Hkv * G * D) and multi.dtype == torch.float32
    for s in range(S):
        one = one_token_attention(q[:, s], kc, vc, valid[:, s], Hkv)
        assert torch.equal(multi[:, s], one[:, 0])


def test_verify_kernel_raises_for_cpu_tensors_and_scales():
    q, kp, vp, pt, lengths = (torch.from_numpy(a)
                              for a in _verify_inputs("float32"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_verify_attention(q, kp, vp, pt, lengths, impl="cuda")
    with pytest.raises(ValueError, match="neither of k_scales"):
        ops.paged_verify_attention(q, kp, vp, pt, lengths, k_scales=kp,
                                   v_scales=vp)


# ---------------------------------------------------------------------------
# block and step level
# ---------------------------------------------------------------------------

def _random_pools(rng, cfg, n_frames, page):
    shape = (n_frames, page, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return k, v


# slot 0 straddles a page edge with its whole draft; slot 1's draft is
# capped at 2 of 4 (rows 3-4, whose positions map to the next page, go to
# the trash frame instead); slot 2 is inert
_PT = np.array([[3, 5, 8, 9], [0, 1, 7, 12], [13, 13, 13, 13]], np.int32)
_POS = np.array([6, 9, 0], np.int32)
_LEN = np.array([K + 1, 3, 0], np.int32)


def test_paged_verify_block_matches_jax(setup):
    """Output rows and the pool after the verify scatter: every valid
    row at ``pos + s``, rows past ``length`` and the inert slot in the
    trash frame only."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    n_frames, page = 14, 4
    k, v = _random_pools(rng, tcfg, n_frames, page)
    x = rng.standard_normal((3, K + 1, tcfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["attn"])
    lp_t = tmodel._layer(tparams["layers"]["attn"], 1)
    ref, (jk2, jv2) = jattn.paged_verify_block(
        lp_j, jcfg, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(_PT), jnp.asarray(_POS), jnp.asarray(_LEN),
        compute_dtype=jnp.float32, impl="xla")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out = tattn.paged_verify_block(
        lp_t, tcfg, torch.from_numpy(x), (tk, tv), torch.from_numpy(_PT),
        torch.from_numpy(_POS), torch.from_numpy(_LEN),
        compute_dtype=torch.float32)
    assert out.shape == x.shape
    _close(ref, out.numpy())
    # the trash frame takes unordered duplicate writes: compare the rest
    _close(jk2[:-1], tk[:-1].numpy())
    _close(jv2[:-1], tv[:-1].numpy())
    written = np.zeros(n_frames - 1, bool)
    for b in range(3):
        for s in range(_LEN[b]):
            written[_PT[b, (_POS[b] + s) // page]] = True
    untouched = ~written
    np.testing.assert_array_equal(tk[:-1].numpy()[untouched],
                                  k[:-1][untouched])
    # slot 1's rows 3..4 (positions 12, 13) would land in frame 12
    assert untouched[12]


def _pools(rng, cfg, n_frames=14, page=4):
    """Random f32 (L, n_frames, page, Hkv, D) K and V pools."""
    k, v = _random_pools(rng, cfg, n_frames, page)
    L = cfg.num_layers
    return (np.broadcast_to(k, (L,) + k.shape).copy(),
            np.broadcast_to(v, (L,) + v.shape).copy())


def _torch_cache(k, v, pt=_PT):
    return tmodel.PagedCache(
        kv={"k_pages": torch.from_numpy(k.copy()),
            "v_pages": torch.from_numpy(v.copy()),
            "page_table": torch.from_numpy(pt.copy())},
        pos=torch.from_numpy(_POS.copy()))


def test_verify_step_matches_jax(setup):
    """Logits (B, S, V) and the pool of a whole verify step, with a
    capped draft and an inert slot; ``pos`` is left alone."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(2)
    k, v = _pools(rng, tcfg)
    jc = jmodel.init_paged_cache(jcfg, 3, 16, k.shape[1], k.shape[2])
    jc = jc._replace(kv=dict(jc.kv, k_pages=jnp.asarray(k),
                             v_pages=jnp.asarray(v),
                             page_table=jnp.asarray(_PT)),
                     pos=jnp.asarray(_POS))
    tc = _torch_cache(k, v)
    toks = rng.integers(0, tcfg.vocab_size, (3, K + 1)).astype(np.int32)
    jl, jc2 = jmodel.verify_step(jparams, jcfg, jc, jnp.asarray(toks),
                                 jnp.asarray(_LEN), impl="xla")
    tl, tc2 = tmodel.verify_step(tparams, tcfg, tc, torch.from_numpy(toks),
                                 torch.from_numpy(_LEN))
    assert tl.shape == (3, K + 1, tcfg.padded_vocab)
    assert tl.dtype == torch.float32
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(tc2.pos.numpy(), _POS)
    for name in ("k_pages", "v_pages"):
        _close(jc2.kv[name][:, :-1], tc2.kv[name][:, :-1].numpy())


def test_verify_step_rows_match_sequential_decode(setup):
    """Row s of a verify step over a matching draft against the s-th of
    S sequential one-token decode steps, and the pools both write.

    Not bitwise on the CPU: the attention rows are (see
    ``test_multi_token_rows_bitwise_one_token``), but the BLAS behind
    the projections rounds a (B * S)-row product differently in the last
    bits from a B-row one (2e-7 here).  So: 1e-5, and the same argmax
    in every row."""
    _, tcfg, _, tparams = setup
    rng = np.random.default_rng(3)
    k, v = _pools(rng, tcfg)
    pt = _PT.copy()
    pt[2] = [2, 4, 6, 10]        # every slot on frames of its own
    tc, seq = _torch_cache(k, v, pt), _torch_cache(k, v, pt)
    full = np.full(3, K + 1, np.int32)
    toks = rng.integers(0, tcfg.vocab_size, (3, K + 1)).astype(np.int32)
    vl, tc = tmodel.verify_step(tparams, tcfg, tc, torch.from_numpy(toks),
                                torch.from_numpy(full))
    for s in range(K + 1):
        dl, seq = tmodel.decode_step(tparams, tcfg, seq,
                                     torch.from_numpy(toks[:, s:s + 1]))
        _close(dl.numpy(), vl[:, s].numpy())
        assert torch.equal(vl[:, s].argmax(-1), dl.argmax(-1)), s
    for name in ("k_pages", "v_pages"):
        _close(seq.kv[name][:, :-1].numpy(), tc.kv[name][:, :-1].numpy())


def test_verify_step_guards(setup):
    _, tcfg, _, tparams = setup
    toks = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="PagedCache"):
        tmodel.verify_step(tparams, tcfg, object(), toks, torch.ones(1))
    swa = dataclasses.replace(tcfg, attention="swa", window=8)
    cache = tmodel.init_paged_cache(tcfg, 1, 8, 3, 4, device="cpu")
    with pytest.raises(ValueError, match="SWA"):
        tmodel.verify_step(tparams, swa, cache, toks, torch.ones(1))


# ---------------------------------------------------------------------------
# the proposer (a copy of repro.serve.speculate)
# ---------------------------------------------------------------------------

def test_ngram_proposer_doctests():
    res = doctest.testmod(speculate)
    assert res.attempted >= 2 and res.failed == 0


def test_ngram_proposer_prompt_lookup():
    p = NgramProposer(n=2, k=3)
    assert p.propose("r", [5, 6, 7, 8, 5, 6]) == [7, 8, 5]
    assert p.propose("x", [1, 2, 3, 4]) == []


def test_ngram_proposer_index_is_incremental_and_droppable():
    p = NgramProposer(n=2, k=2)
    hist = [1, 2, 3, 1, 2]
    assert p.propose("r", hist) == [3, 1]
    hist = hist + [3, 1, 2]
    assert p.propose("r", hist) == [3, 1]
    p.drop("r")
    assert "r" not in p._idx


def test_ngram_key_is_order_sensitive():
    assert ngram_key([1, 2, 3]) != ngram_key([3, 2, 1])
    assert ngram_key([1, 2, 3]) == ngram_key(np.array([1, 2, 3], np.int32))


@pytest.mark.parametrize("n,k", [(0, 2), (2, 0)])
def test_ngram_proposer_validates_params(n, k):
    with pytest.raises(ValueError):
        NgramProposer(n=n, k=k)


def test_ngram_proposer_matches_jax_copy():
    """Same drafts as the JAX package's proposer over a growing
    history."""
    from repro.serve.speculate import NgramProposer as JaxNgram

    rng = np.random.default_rng(4)
    hist = list(rng.integers(0, 5, 40))
    ours, theirs = NgramProposer(n=2, k=K), JaxNgram(n=2, k=K)
    for end in range(1, len(hist) + 1):
        assert ours.propose(0, hist[:end]) == theirs.propose(0, hist[:end])


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

MAX_LEN, PAGE, POOL = 32, 4, 10


def _requests(vocab):
    """Prompts that repeat a 6-token base, so prompt lookup drafts."""
    rng = np.random.default_rng(7)
    base = rng.integers(1, vocab, 6)
    return [(np.concatenate([base, base, rng.integers(1, vocab, i + 1)]),
             int(rng.integers(8, 13))) for i in range(5)]


class _Oracle:
    """Drafts the plain run's continuation: every draft matches."""

    def __init__(self, refs, prompt_lens, k):
        self.refs, self.prompt_lens, self.k = refs, prompt_lens, k

    def propose(self, rid, history):
        n = len(history) - self.prompt_lens[rid]
        return list(self.refs[rid][n:n + self.k])

    def drop(self, rid):
        pass


class _Wrong(_Oracle):
    """Reference token + 1: rejected at row 0 on every verify step."""

    def __init__(self, refs, prompt_lens, k, vocab):
        super().__init__(refs, prompt_lens, k)
        self.vocab = vocab

    def propose(self, rid, history):
        return [(t + 1) % self.vocab for t in super().propose(rid, history)]


class _FirstRight(_Wrong):
    """First draft right, the rest wrong: one accepted per step."""

    def propose(self, rid, history):
        right = _Oracle.propose(self, rid, history)
        return right[:1] + [(t + 1) % self.vocab for t in right[1:]]


def _factory(kind, refs, requests, vocab):
    lens = {i: len(p) for i, (p, _) in enumerate(requests)}
    return {"ngram": None,
            "oracle": lambda n, k: _Oracle(refs, lens, k),
            "wrong": lambda n, k: _Wrong(refs, lens, k, vocab),
            "first": lambda n, k: _FirstRight(refs, lens, k, vocab)}[kind]


def _econf(mod, speculate_k=0, factory=None, **extra):
    return mod.EngineConfig(
        max_batch=3, max_len=MAX_LEN,
        paging=mod.PagingConfig(page_size=PAGE, device_pages=POOL,
                                hot_tail_pages=1),
        chunking=mod.ChunkingConfig(chunk_tokens=8, chunk_slots=2),
        speculation=mod.SpeculationConfig(speculate_k=speculate_k,
                                          speculate_ngram=2,
                                          proposer_factory=factory),
        **extra)


def _serve(engine_cls, cfg, params, econf, requests, wrap=None):
    eng = engine_cls(cfg, params, econf)
    if wrap:
        wrap(eng)
    for prompt, new in requests:
        eng.submit(prompt, max_new_tokens=new)
    return eng, eng.run()


def _count_mixed_verify(eng):
    """Count the steps that verify drafts fused with a prompt chunk."""
    inner = eng._mixed_verify
    eng.mixed_verify_calls = 0

    def counted(*args):
        eng.mixed_verify_calls += 1
        return inner(*args)

    eng._mixed_verify = counted


@pytest.fixture(scope="module")
def engines(setup):
    """The port's plain run (the reference tokens), then the port's and
    the JAX package's spec engines, one pair per proposer kind."""
    jcfg, tcfg, jparams, tparams = setup
    requests = _requests(tcfg.vocab_size)
    plain, refs = _serve(Engine, tcfg, tparams, _econf(tconf, device="cpu"),
                         requests)
    runs = {}
    for kind in ("oracle", "wrong", "first", "ngram"):
        fac = _factory(kind, refs, requests, tcfg.vocab_size)
        runs[kind] = (
            _serve(Engine, tcfg, tparams,
                   _econf(tconf, K, fac, device="cpu"), requests,
                   wrap=_count_mixed_verify),
            _serve(JaxEngine, jcfg, jparams, _econf(jconf, K, fac),
                   requests))
    return requests, (plain, refs), runs


KINDS = ["oracle", "wrong", "first", "ngram"]


@pytest.mark.parametrize("kind", KINDS)
def test_spec_engine_matches_jax_spec_engine(engines, kind):
    _, _, runs = engines
    (teng, tout), (jeng, jout) = runs[kind]
    assert tout == jout
    assert {c: teng.stats[c] for c in SPEC_COUNTERS} == \
        {c: jeng.stats[c] for c in SPEC_COUNTERS}
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)


@pytest.mark.parametrize("kind", KINDS)
def test_spec_engine_token_exact_with_plain_engine(engines, kind):
    """Every proposer gives the plain run's tokens, the counters balance,
    rollback returns every page to the pool, and the pool preempted."""
    requests, (plain, refs), runs = engines
    (teng, tout), _ = runs[kind]
    assert tout == refs
    assert all(len(tout[i]) == n for i, (_, n) in enumerate(requests))
    teng.check_invariants()
    s = teng.stats
    assert s["accepted"] + s["rejected"] == s["drafted"]
    assert s["spec_steps"] > 0 and s["drafted"] > 0
    assert teng.page_pool.n_free == teng.page_pool.n_pages
    assert s["preemptions"] > 0 and s["resumes"] > 0
    assert plain.stats["preemptions"] > 0


def test_spec_acceptance_by_proposer(engines):
    """Oracle: all accepted and fewer steps than plain; wrong: every
    draft rejected (each verify step rolls back); first-right: partial."""
    _, (plain, _), runs = engines
    oracle = runs["oracle"][0][0].stats
    wrong = runs["wrong"][0][0].stats
    first = runs["first"][0][0].stats
    assert oracle["rejected"] == 0 and oracle["accepted"] > 0
    assert oracle["steps"] < plain.stats["steps"]
    assert wrong["accepted"] == 0 and wrong["rejected"] == wrong["drafted"]
    assert 0 < first["accepted"] < first["drafted"]


def test_spec_steps_share_mixed_steps_with_chunks(engines):
    """Verify steps fused with prompt chunks ran, and the stream stayed
    exact through them (the proposers that draft on every step; prompt
    lookup drafts only where its n-gram recurs)."""
    _, (_, refs), runs = engines
    for kind in ("oracle", "wrong", "first"):
        (teng, tout), _ = runs[kind]
        assert teng.mixed_verify_calls > 0, kind
        assert tout == refs


def test_spec_counters_seeded_only_when_speculating(engines):
    _, (plain, _), runs = engines
    assert "spec_steps" not in plain.stats
    assert "drafted" in runs["ngram"][0][0].stats


def test_spec_trace_reproduces_spec_counters(setup, engines):
    """The verify instants a traced run records sum to its counters."""
    _, tcfg, _, tparams = setup
    requests, _, _ = engines
    eng, _ = _serve(Engine, tcfg, tparams,
                    _econf(tconf, K, device="cpu",
                           obs=tconf.ObsConfig(trace=True)), requests)
    trace = eng.export_trace()
    verify = [e for e in trace["traceEvents"]
              if e.get("ph") == "i" and e.get("name") == "verify"]
    assert len(verify) == eng.stats["spec_steps"] > 0
    for key in ("drafted", "accepted", "rejected"):
        assert sum(e["args"][key] for e in verify) == eng.stats[key]
