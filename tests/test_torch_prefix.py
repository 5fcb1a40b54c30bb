"""Cross-request prefix sharing in the port against the JAX package.

Host pieces first: ``page_hashes`` gives the reference's bytes, the
prefix cache caps its hits before the prompt's last token, and
``remap_private`` gives a writer a private frame.  Then the copy-on-write
frame copies, bitwise the reference's on the same pools (bf16, int8,
fp8), and the engine's ``_ensure_private`` on a shared frame.  Then
engines: on bridged f32 SMOKE weights the port's engine with
``prefix_cache`` must emit the JAX engine's greedy tokens with the same
counters (``prefix_hits``, ``prefix_tokens_saved``, ``prefix_far_hits``,
the cache's ``interned``, preemptions and resumes) and the same pager
traffic — device hits, far hits landing while ARRIVING (a slow pager),
an AMU fault in the middle of a far-hit admission (a flaky pager), the
int8 and fp8 pools, speculation, and an MoE config.  Last, the CPU
rehearsal of ``chip_smoke.py`` phase 3p at the smoke width with the full
width's page bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import amu as jamu
from repro.kernels import kv_quant as jq
from repro.models import init_params as jax_init_params
from repro import paging as jpaging
from repro.serve import config as jconf
from repro.serve import transfer as jtransfer
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.core import amu as tamu
from repro_torch import paging as tpaging
from repro_torch.paging import PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve import transfer as ttransfer
from repro_torch.serve.engine import Engine

SIDES = {"jax": (jconf, jamu, jpaging, JaxEngine),
         "torch": (tconf, tamu, tpaging, Engine)}
TORCH_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these engines run small tensors, and the
    test runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


@pytest.fixture(scope="module")
def phi4():
    return _weights("phi4-mini-3.8b")


def _requests(vocab, n, shared=12, tail=4, new=5, seed=3):
    """``n`` prompts of one shared ``shared``-token prefix and a unique
    ``tail``, ``new`` tokens each."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, shared)
    return [(np.concatenate([pre, rng.integers(0, vocab, tail)]), new)
            for _ in range(n)]


def _slow(latency, fail=None):
    """Pager factory maker: a simulated AMU of ``latency`` per transfer
    that faults as a transfer starts while ``fail['on']``."""
    def make(amu, paging):
        def latency_fn(req):
            if fail is not None and fail["on"]:
                raise RuntimeError("injected far-memory fault")
            return latency

        def factory(pool, table, *, page_nbytes):
            backend = amu.SimBackend(base_latency=latency, bandwidth=10e9,
                                     latency_fn=latency_fn)
            return paging.Pager(pool, table,
                                amu.AMU(backend=backend, max_outstanding=64),
                                page_nbytes=page_nbytes)
        return factory
    return make


def _econf(side, *, max_batch=2, device_pages=None, hot_tail=1,
           pager=None, kv_quant="none", k=0, prefix=True):
    conf, amu, paging, _ = SIDES[side]
    extra = {"device": "cpu"} if side == "torch" else {}
    return conf.EngineConfig(
        max_batch=max_batch, max_len=64,
        paging=conf.PagingConfig(
            page_size=4, device_pages=device_pages, hot_tail_pages=hot_tail,
            kv_quant=kv_quant,
            pager_factory=pager(amu, paging) if pager else None),
        chunking=conf.ChunkingConfig(chunk_tokens=4, prefix_cache=prefix),
        speculation=conf.SpeculationConfig(speculate_k=k), **extra)


def _serve(side, weights, requests, runs=(None,), **kw):
    """Build ``side``'s engine, submit ``requests`` and call ``run``
    once per entry of ``runs`` (``(max_steps, hook)``: the hook runs
    before that call)."""
    cfg, params = weights[side]
    eng = SIDES[side][3](cfg, params, _econf(side, **kw))
    for p, n in requests:
        eng.submit(p, max_new_tokens=n)
    out = None
    for run in runs:
        if run is None:
            out = eng.run()
        else:
            steps, hook = run
            hook()
            out = eng.run(max_steps=steps)
    return eng, out


def _both(weights, requests, **kw):
    jeng, jout = _serve("jax", weights, requests, **kw)
    teng, tout = _serve("torch", weights, requests, **kw)
    return (jeng, jout), (teng, tout)


def _same(jax_run, torch_run):
    """Token-exact, with the same counters, prefix-cache and pager
    stats."""
    (jeng, jout), (teng, tout) = jax_run, torch_run
    assert tout == jout
    assert dict(teng.stats) == dict(jeng.stats)
    assert teng.prefix.stats == jeng.prefix.stats
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)
    teng.check_invariants()


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,page", [(16, 4), (37, 4), (64, 16), (7, 8)])
def test_page_hashes_bytes_match_reference(n, page):
    prompt = np.random.default_rng(n).integers(0, 200064, n)
    assert tpaging.page_hashes(prompt, page) == \
        jpaging.page_hashes(prompt, page)
    assert len(tpaging.page_hashes(prompt, page)) == n // page


def test_prefix_cache_caps_hits_before_last_token():
    """A full-prompt hit leaves at least the final token to compute
    (the first sampled token needs logits at plen - 1)."""
    pool = tpaging.PagePool(8, 4)
    table = tpaging.PageTable(pool)
    pager = tpaging.Pager(pool, table, page_nbytes=1 << 10)
    cache = tpaging.PrefixCache(pool, table, pager, page_size=4)
    prompt = np.arange(8, dtype=np.int32)
    table.register("donor")
    table.ensure_capacity("donor", 8)
    cache.intern(prompt, "donor", lambda phys: {"k": None, "v": None})
    assert cache.stats["interned"] == 2
    assert len(cache.match(prompt)) == 1
    assert len(cache.match(np.arange(12, dtype=np.int32))) == 2
    other = np.concatenate([[5], np.arange(1, 12)]).astype(np.int32)
    assert cache.match(other) == []
    assert tpaging.PREFIX_SEQ in table.sequences()


def test_remap_private_keeps_other_sharers():
    pool = tpaging.PagePool(8, 4)
    table = tpaging.PageTable(pool)
    table.register("a")
    table.register("b")
    table.ensure_capacity("a", 4)
    phys = table.entry("a", 0).phys
    table.append_shared("b", phys)
    pool.mark_cow(phys)
    table.pin_page("b", 0)
    assert pool.frames[phys].refs == 2
    old, new = table.remap_private("b", 0)
    assert old == phys and new != phys
    assert pool.frames[phys].refs == 1
    assert pool.frames[new].refs == 1 and pool.frames[new].pins == 1
    assert table.entry("b", 0).phys == new
    assert table.entry("a", 0).phys == phys
    assert table.remap_private("a", 0) == (phys, phys)


# ---------------------------------------------------------------------------
# copy-on-write frame copies
# ---------------------------------------------------------------------------

POOL = (3, 9, 4, 2, 16)          # (L, frames, page, Hkv, D)


def _pools(mode, rng):
    """The same K/V pools (and, quantized, scales) in JAX and torch."""
    x = rng.standard_normal((2,) + POOL).astype(np.float32)
    if mode == "none":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        raw = np.asarray(j).view(np.int16).copy()
        t = torch.from_numpy(raw).view(torch.bfloat16)
        return list(j), list(t.clone()), None
    q = jq.KVQuantConfig(mode)
    s = (np.abs(x).max(axis=(3, 5)) / np.float32(q.qmax)).astype(np.float32)
    j = jq.quantize(jnp.asarray(x), jnp.asarray(s)[:, :, :, None, :, None],
                    q)
    t = torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(
        TORCH_DTYPE[mode])
    return list(j), list(t.clone()), s


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_copy_frame_bitwise_reference(mode):
    rng = np.random.default_rng(5)
    jkv, tkv, s = _pools(mode, rng)
    src, dst = 2, 6
    if s is None:
        jout = jtransfer._copy_frame(*jkv, jnp.int32(src), jnp.int32(dst))
        ttransfer._copy_frame(*tkv, src, dst)
        touts = tkv
    else:
        ts = [torch.from_numpy(a.copy()) for a in s]
        jout = jtransfer._copy_frame_q(*jkv, *(jnp.asarray(a) for a in s),
                                       jnp.int32(src), jnp.int32(dst))
        ttransfer._copy_frame_q(*tkv, *ts, src, dst)
        touts = tkv + ts
    for j, t in zip(jout, touts):
        np.testing.assert_array_equal(_raw(t), _raw(j))
    np.testing.assert_array_equal(_raw(touts[0][:, dst]),
                                  _raw(touts[0][:, src]))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_ensure_private_copies_shared_frame(phi4, kv_quant):
    """The engine's COW break on a frame shared with the prefix cache:
    the request is remapped onto a new frame whose bytes (and scales)
    equal the old frame's, and the old frame is untouched — the check
    ``chip_smoke.py`` phase 3p makes on the card."""
    import chip_smoke
    cfg, params = phi4["torch"]
    eng = Engine(cfg, params, _econf("torch", kv_quant=kv_quant))
    for p, n in _requests(cfg.vocab_size, 2):
        eng.submit(p, max_new_tokens=n)
    eng.run()
    res = chip_smoke.check_cow(eng)
    assert res["old"] != res["new"]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_device_hits_match_jax_engine(phi4):
    reqs = _requests(phi4["torch"][0].vocab_size, 6)
    jr, tr = _both(phi4, reqs)
    _same(jr, tr)
    teng, tout = tr
    assert teng.stats["prefix_hits"] > 0
    assert teng.stats["prefix_tokens_saved"] >= 12
    assert teng.prefix.stats["interned"] > 0
    # inside the port: the tokens of an engine without the cache
    _, plain = _serve("torch", phi4, reqs, prefix=False)
    assert plain == tout


def test_far_hit_while_arriving_matches_jax_engine(phi4):
    """A pool too small to keep the cache resident: the shared pages
    come back from the far tier with multi-tick latency, so later hits
    land while pages are still ARRIVING."""
    reqs = _requests(phi4["torch"][0].vocab_size, 6)
    jr, tr = _both(phi4, reqs, device_pages=9, hot_tail=0,
                   pager=_slow(2.5e-3))
    _same(jr, tr)
    teng = tr[0]
    assert teng.stats["prefix_far_hits"] > 0
    assert teng.pager.stats["arrived"] > 0


def test_fault_mid_admission_matches_jax_engine(phi4):
    """An AMU fault while a far hit's pages are fetched: the pager
    reverts ARRIVING to PARKED, the retry fetches again, and both
    engines still agree."""
    reqs = _requests(phi4["torch"][0].vocab_size, 4)
    runs = {}
    for side in ("jax", "torch"):
        fail = {"on": False}

        def flip(on, fail=fail):
            return lambda: fail.__setitem__("on", on)
        runs[side] = _serve(side, phi4, reqs,
                            runs=((4, flip(False)), (6, flip(True)),
                                  (10_000, flip(False))),
                            max_batch=1, device_pages=7, hot_tail=0,
                            pager=_slow(1e-4, fail))
    _same(runs["jax"], runs["torch"])
    assert runs["torch"][0].stats["prefix_hits"] > 0


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_pool_prefix_matches_jax_engine(phi4, kv_quant):
    """Shared int8 / fp8 frames: far hits move bytes and scales."""
    reqs = _requests(phi4["torch"][0].vocab_size, 6)
    jr, tr = _both(phi4, reqs, device_pages=9, hot_tail=0,
                   pager=_slow(2.5e-3), kv_quant=kv_quant)
    _same(jr, tr)
    assert tr[0].stats["prefix_hits"] > 0
    assert tr[0].cache.kv["k_pages"].dtype == TORCH_DTYPE[kv_quant]


def test_speculation_with_prefix_matches_jax_engine(phi4):
    """verify-K (K = 2, the n-gram proposer) over shared frames: the
    COW guard covers the draft window, rewinds keep the cache intact."""
    vocab = phi4["torch"][0].vocab_size
    rng = np.random.default_rng(11)
    pre = np.tile(rng.integers(0, vocab, 4), 3)       # drafts find matches
    reqs = [(np.concatenate([pre, rng.integers(0, vocab, 4), pre[:4]]), 8)
            for _ in range(5)]
    jr, tr = _both(phi4, reqs, k=2, device_pages=14)
    _same(jr, tr)
    s = tr[0].stats
    assert s["prefix_hits"] > 0 and s["drafted"] > 0


def test_moe_prefix_matches_jax_engine():
    olmoe = _weights("olmoe-1b-7b")
    reqs = _requests(olmoe["torch"][0].vocab_size, 4)
    jr, tr = _both(olmoe, reqs)
    _same(jr, tr)
    assert tr[0].stats["prefix_hits"] > 0


# ---------------------------------------------------------------------------
# the reference's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [
    {"cfg": {"attention": "swa", "window": 32}},
    {"chunking": {"chunk_tokens": None}},
    {"paging": {"enabled": False}},
    {"speculation": {"speculate_k": 2}, "role": "prefill"},
])
def test_reference_refusals_raise_paging_error(change):
    """The JAX engine's rules: prefix sharing needs chunked paged
    admission and global-attention dense/moe; a PREFILL engine does not
    speculate.  Both engines raise ``PagingError``, the port before its
    own ``NotImplementedError``."""
    for side in ("jax", "torch"):
        conf = SIDES[side][0]
        cfg = dataclasses.replace(
            (jax_smoke if side == "jax" else get_smoke)("phi4-mini-3.8b"),
            **change.get("cfg", {}))
        econf = _econf(side)
        for group in ("chunking", "paging", "speculation"):
            if group in change:
                econf = dataclasses.replace(econf, **{group: (
                    dataclasses.replace(getattr(econf, group),
                                        **change[group]))})
        if "role" in change:
            econf = dataclasses.replace(econf, role=change["role"])
        with pytest.raises((PagingError, jpaging.PagingError)):
            if side == "jax":
                JaxEngine(cfg, jax_init_params(cfg, jax.random.PRNGKey(0)),
                          econf)
            else:
                Engine(cfg, {}, econf)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 3p, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_prefix_settings():
    """Phase 3p's runs at the smoke width with the full width's page
    bytes (scheduling reads shapes and page bytes only): A (the cache on
    448 frames) saves every later request's shared prefix and runs fewer
    chunks than B (no cache); C, on ``chip_smoke.PREFIX_FAR_PAGES``
    frames, hits the cache's parked frames far; all three agree."""
    import chip_smoke
    cfg, params, factory = chip_smoke_rehearsal()
    runs = {}
    for tag, pages, prefix in (("A", chip_smoke.ENGINE["device_pages"], True),
                               ("B", chip_smoke.ENGINE["device_pages"], False),
                               ("C", chip_smoke.PREFIX_FAR_PAGES, True)):
        runs[tag] = chip_smoke.serve_prefix(cfg, params, "cpu", pages,
                                            prefix, pager_factory=factory)
    chip_smoke.check_prefix_runs(runs)


def chip_smoke_rehearsal():
    """One smoke-width layer and a pager that accounts full-width page
    bytes: the engine decides as it does at full width."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    full = get_config("phi4-mini-3.8b")
    full_nbytes = (2 * full.num_layers * chip_smoke.ENGINE["page_size"]
                   * full.num_kv_heads * full.head_dim * 2)

    def factory(pool, table, *, page_nbytes):
        return tpaging.Pager(pool, table, page_nbytes=full_nbytes)

    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), num_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params, factory
