"""Disaggregated prefill/decode and finished-sequence offload in the port
against the JAX package.

A PREFILL-role and a DECODE-role engine over ONE shared far tier must
emit the port's FUSED engine's tokens and the JAX pair's, with the same
handoff counters and pager traffic; a fault inside the handoff fetch
leaves every tier entry in place for a retry; records cross processes
through a spool; a DECODE engine mixes adopted and local requests;
``fetch_finished`` reassembles a finished sequence within one bf16 ulp
of the JAX engine's and keeps the tier entries when a fetch faults.
The CLI runs ``--disagg`` and ``--prefix-cache --shared-prefix``, and
``chip_smoke.py`` phases 3d and 3f are rehearsed at the smoke width.
Every engine runs on bridged f32 SMOKE weights of phi4-mini-3.8b.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import amu as jamu
from repro.core import offload as joffload
from repro.models import init_params as jax_init_params
from repro import paging as jpaging
from repro.serve import config as jconf
from repro.serve import disagg as jdisagg
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.core import amu as tamu
from repro_torch.core import offload as toffload
from repro_torch import paging as tpaging
from repro_torch.core.amu import AMUError
from repro_torch.paging import PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve import disagg as tdisagg
from repro_torch.serve.config import EngineRole
from repro_torch.serve.engine import Engine

SIDES = {"jax": (jconf, jamu, joffload, jpaging, jdisagg, JaxEngine),
         "torch": (tconf, tamu, toffload, tpaging, tdisagg, Engine)}
#: (prompt length, new tokens): the 1-token request finishes on the
#: prefill side (``rec.done``)
SHAPES = ((7, 5), (13, 4), (21, 1), (5, 6))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these engines run small tensors, and the
    test runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                               compute_dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


def _requests(vocab, shapes=SHAPES, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=n).astype(np.int32), m)
            for n, m in shapes]


def _econf(side, role="fused", *, factory=None, handoff=None,
           device_pages=20, offload=False, kv_quant="none"):
    conf = SIDES[side][0]
    extra = {"device": "cpu"} if side == "torch" else {}
    if handoff is not None:
        extra["handoff"] = handoff
    return conf.EngineConfig(
        max_batch=3, max_len=64, role=role,
        paging=conf.PagingConfig(page_size=8, device_pages=device_pages,
                                 pager_factory=factory,
                                 offload_finished=offload,
                                 kv_quant=kv_quant),
        chunking=conf.ChunkingConfig(chunk_tokens=8), **extra)


def _flaky_tier(side, fail):
    """A shared tier whose AMU faults as a transfer starts while
    ``fail['on']``."""
    _, amu, offload, *_ = SIDES[side]

    def latency_fn(req):
        if fail["on"]:
            raise RuntimeError("injected handoff fault")
        return 1e-6
    return offload.FarMemoryTier(amu.AMU(amu.SimBackend(
        base_latency=1e-6, bandwidth=10e9, latency_fn=latency_fn)))


def _pair(side, weights, tier=None):
    """A (PREFILL, DECODE) pair over one shared tier."""
    disagg, engine = SIDES[side][4], SIDES[side][5]
    cfg, params = weights[side]
    tier = tier if tier is not None else disagg.make_shared_tier()
    mk = disagg.tier_pager_factory(tier)
    pe = engine(cfg, params, _econf(side, "prefill", factory=mk))
    de = engine(cfg, params, _econf(side, "decode", factory=mk,
                                    handoff=pe.handoff))
    return pe, de, tier


def _fused(side, weights, requests, **kw):
    cfg, params = weights[side]
    eng = SIDES[side][5](cfg, params, _econf(side, **kw))
    for p, m in requests:
        eng.submit(p, max_new_tokens=m)
    return eng, eng.run()


@pytest.fixture(scope="module")
def pipeline(weights):
    """The JAX pair's and the port's pair's runs of ``SHAPES``."""
    reqs = _requests(weights["torch"][0].vocab_size)
    runs = {}
    for side in ("jax", "torch"):
        pe, de, tier = _pair(side, weights)
        for p, m in reqs:
            pe.submit(p, max_new_tokens=m)
        out = SIDES[side][4].run_disaggregated(pe, de)
        runs[side] = (pe, de, tier, out)
    return reqs, runs


# ---------------------------------------------------------------------------
# role wiring
# ---------------------------------------------------------------------------

def test_roles_wire_like_the_reference(weights):
    """FUSED carries no handoff surface; PREFILL implies the offload and
    makes its board; the pair shares one tier, three AMUs."""
    cfg, params = weights["torch"]
    eng = Engine(cfg, params, _econf("torch"))
    assert eng.role is EngineRole.FUSED and eng.handoff is None
    assert "handoffs" not in eng.stats
    with pytest.raises(PagingError):
        eng.admit_handoff(object())
    pe, de, tier = _pair("torch", weights)
    assert pe.role is EngineRole.PREFILL and de.role is EngineRole.DECODE
    assert pe.offload_finished and not de.offload_finished
    assert isinstance(pe.handoff, tdisagg.HandoffBoard)
    assert de.handoff is pe.handoff
    assert pe.far_tier is tier and de.far_tier is tier
    assert pe.pager.amu is not de.pager.amu is not tier.amu
    assert pe.params["embed"]["table"] is de.params["embed"]["table"]


def test_run_disaggregated_validates_pair(weights):
    cfg, params = weights["torch"]
    pe, de, _ = _pair("torch", weights)
    fused = Engine(cfg, params, _econf("torch"))
    with pytest.raises(PagingError):
        tdisagg.run_disaggregated(fused, de)        # wrong prefill role
    with pytest.raises(PagingError):
        tdisagg.run_disaggregated(pe, pe)           # wrong decode role
    pe2, _, _ = _pair("torch", weights)
    with pytest.raises(PagingError):
        tdisagg.run_disaggregated(pe2, de)          # different tiers


# ---------------------------------------------------------------------------
# token-exactness
# ---------------------------------------------------------------------------

def test_pipeline_matches_jax_pair_and_fused_engine(weights, pipeline):
    reqs, runs = pipeline
    jpe, jde, _, jout = runs["jax"]
    tpe, tde, tier, tout = runs["torch"]
    assert tout == jout
    _, fused = _fused("torch", weights, reqs)
    assert tout == fused
    assert tpe.stats["handoffs"] == len(reqs) == tde.stats["handoffs"]
    assert dict(tpe.stats) == dict(jpe.stats)
    assert dict(tde.stats) == dict(jde.stats)
    assert dict(tpe.pager.stats) == dict(jpe.pager.stats)
    assert dict(tde.pager.stats) == dict(jde.pager.stats)
    assert tpe.handoff.published == tpe.handoff.consumed == len(reqs)
    assert tde.stats["chunks"] == 0
    for rid in tout:
        assert not any(isinstance(k, tuple) and k[0] == rid
                       for k in tier.keys())


def test_record_done_at_first_token_finishes_on_admission(weights):
    """A 1-token request graduates done: the DECODE engine finishes it at
    admission and clears its tier entries; it never takes a slot."""
    reqs = _requests(weights["torch"][0].vocab_size, ((21, 1),))
    pe, de, tier = _pair("torch", weights)
    pe.submit(*reqs[0][:1], max_new_tokens=1)
    pe.run()
    rec, = pe.handoff.poll()
    assert rec.done and (rec.rid, "aux") in tier
    de.admit_handoff(rec)
    assert rec.rid in de.finished and not de.queue
    assert not any(isinstance(k, tuple) and k[0] == rec.rid
                   for k in tier.keys())
    _, ref = _fused("torch", weights, reqs)
    assert de.finished[rec.rid].generated == ref[0]


def test_fault_during_handoff_admission_retries(weights):
    """A fault inside the residue fetch raises with every tier entry
    intact and nothing mutated on the decode side; the same records
    admit on retry, and both packages agree."""
    reqs = _requests(weights["torch"][0].vocab_size, ((11, 5), (17, 4)), 5)
    outs = {}
    for side in ("jax", "torch"):
        fail = {"on": False}
        pe, de, tier = _pair(side, weights, _flaky_tier(side, fail))
        for p, m in reqs:
            pe.submit(p, max_new_tokens=m)
        pe.run()
        recs = pe.handoff.poll()
        assert len(recs) == 2
        fail["on"] = True
        with pytest.raises((AMUError, jamu.AMUError)):
            de.admit_handoff(recs[0])
        rid = recs[0].rid
        assert (rid, "aux") in tier
        assert all((rid, l) in tier for l in range(recs[0].n_pages))
        assert de.stats["handoffs"] == 0
        assert not de.queue and rid not in de.page_table.sequences()
        fail["on"] = False
        for rec in recs:
            de.admit_handoff(rec)
        outs[side] = (de.run(), dict(de.stats), dict(de.pager.stats))
        de.check_invariants()
    assert outs["torch"] == outs["jax"]
    _, ref = _fused("torch", weights, reqs)
    assert outs["torch"][0] == ref


def test_spool_roundtrip_across_tiers(weights, tmp_path):
    """The two-process handoff: records plus tier entries (host tensors)
    spooled to disk install into another tier and decode token-exact."""
    reqs = _requests(weights["torch"][0].vocab_size, ((9, 4), (15, 5)), 9)
    pe, _, tier_a = _pair("torch", weights)
    for p, m in reqs:
        pe.submit(p, max_new_tokens=m)
    pe.run()
    recs = pe.handoff.poll()
    path = str(tmp_path / "handoff.pkl")
    tdisagg.spool_save(path, recs, tier_a)
    _, de, tier_b = _pair("torch", weights)
    loaded = tdisagg.spool_load(path, tier_b)
    assert [r.rid for r in loaded] == [r.rid for r in recs]
    for rec in loaded:
        de.admit_handoff(rec)
    _, ref = _fused("torch", weights, reqs)
    assert de.run() == ref


def test_decode_engine_mixes_handoffs_with_local_submissions(weights):
    vocab = weights["torch"][0].vocab_size
    hand, local = _requests(vocab, ((10, 4), (8, 3)), 11)
    pe, de, _ = _pair("torch", weights)
    pe.submit(hand[0], max_new_tokens=hand[1])
    pe.run()
    rec = pe.handoff.poll()[0]
    de.admit_handoff(rec)
    local_rid = de.submit(local[0], max_new_tokens=local[1])
    assert local_rid > rec.rid
    out = de.run()
    assert out[rec.rid] == _fused("torch", weights, [hand])[1][0]
    assert out[local_rid] == _fused("torch", weights, [local])[1][0]
    de.check_invariants()


# ---------------------------------------------------------------------------
# finished-sequence offload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_fetch_finished_matches_jax_engine(weights, kv_quant):
    """The reassembled K/V within one bf16 ulp of the JAX engine's (a
    quantized pool's pages dequantized by their own scales), zero past
    the sequence; the tier entries go with the fetch."""
    reqs = _requests(weights["torch"][0].vocab_size, ((13, 5), (22, 4)), 7)
    runs = {side: _fused(side, weights, reqs, offload=True,
                         kv_quant=kv_quant, device_pages=8)
            for side in ("jax", "torch")}
    (jeng, jout), (teng, tout) = runs["jax"], runs["torch"]
    assert tout == jout
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)
    for rid, (p, m) in enumerate(reqs):
        jc, tc = jeng.fetch_finished(rid), teng.fetch_finished(rid)
        assert int(tc.pos[0]) == int(np.asarray(jc.pos)[0]) == len(p) + m - 1
        for name in ("k", "v"):
            want = np.asarray(jc.kv[name]).astype(np.float32)
            got = tc.kv[name].float().numpy()
            assert tc.kv[name].dtype == torch.bfloat16
            assert got.shape == want.shape == (3, 1, 64, 2, 16)
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
            assert not got[:, :, int(tc.pos[0]):].any()
        assert not any(isinstance(k, tuple) and k[0] == rid
                       for k in teng.far_tier.keys())
    with pytest.raises(PagingError):
        Engine(*weights["torch"], _econf("torch")).fetch_finished(0)


def test_fetch_finished_fault_keeps_tier_entries(weights):
    """A fault mid-fetch raises and every page survives; the retry
    reassembles the same cache."""
    reqs = _requests(weights["torch"][0].vocab_size, ((13, 5),), 7)
    fail = {"on": False}

    def factory(pool, table, *, page_nbytes):
        def latency_fn(req):
            if fail["on"]:
                raise RuntimeError("injected far-memory fault")
            return 1e-6
        amu = tamu.AMU(backend=tamu.SimBackend(
            base_latency=1e-6, bandwidth=10e9, latency_fn=latency_fn))
        return tpaging.Pager(pool, table, amu, page_nbytes=page_nbytes)

    eng, _ = _fused("torch", weights, reqs, offload=True, factory=factory)
    n_pages = eng.far_tier.home((0, "aux"))["pages"]
    fail["on"] = True
    with pytest.raises(AMUError):
        eng.fetch_finished(0)
    assert (0, "aux") in eng.far_tier
    assert all((0, l) in eng.far_tier for l in range(n_pages))
    fail["on"] = False
    cache = eng.fetch_finished(0)
    ref_eng, _ = _fused("torch", weights, reqs, offload=True)
    ref = ref_eng.fetch_finished(0)
    assert torch.equal(cache.kv["k"], ref.kv["k"])
    assert torch.equal(cache.kv["v"], ref.kv["v"])
    assert (0, "aux") not in eng.far_tier


@pytest.mark.parametrize("n_tokens", [8, 9, 16])
def test_split_join_kv_pages_match_reference(n_tokens):
    """The page helpers ``fetch_finished`` returns through: the same
    pages and the same reassembled K/V as the JAX package's, bit-exact,
    zero past ``n_tokens``; the aux residue of a dense-family cache is
    its position."""
    from repro.models.model import Cache as JCache
    from repro.serve import kv_cache as jkv
    from repro_torch.models.model import Cache
    from repro_torch.serve import kv_cache as tkv

    rng = np.random.default_rng(0)
    k, v = rng.standard_normal((2, 2, 1, 16, 2, 8)).astype(np.float32)
    jres, jpages = jkv.split_kv_pages(JCache(
        kv={"k": k, "v": v}, ssm=(), cross={},
        pos=np.full((1,), 16, np.int32)), 8, n_tokens)
    tres, tpages = tkv.split_kv_pages(Cache(
        kv={"k": torch.from_numpy(k), "v": torch.from_numpy(v)}, ssm=(),
        cross={}, pos=torch.full((1,), 16, dtype=torch.int32)), 8, n_tokens)
    assert [pg["k"].shape[2] for pg in tpages] == \
        [pg["k"].shape[2] for pg in jpages]
    jj = jkv.join_kv_pages(jres, jpages, 16)
    tj = tkv.join_kv_pages(tres, tpages, 16)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tj.kv[name].numpy(),
                                      np.asarray(jj.kv[name]))
        assert not tj.kv[name][:, :, n_tokens:].any()
    paged = Cache(kv={}, ssm=(), cross={},
                  pos=torch.tensor([3, 9, 5], dtype=torch.int32))
    aux = tkv.extract_aux_slot(paged, 1, 3)
    assert aux["ssm"] == () and aux["cross"] == {}
    assert aux["pos"].tolist() == [9]
    tkv.insert_aux_slot(paged, aux, 2, 3)
    assert paged.pos.tolist() == [3, 9, 9]


# ---------------------------------------------------------------------------
# the CLI and chip_smoke.py's phases, rehearsed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--disagg"],
    ["--prefix-cache", "--shared-prefix", "48", "--max-batch", "2"],
    ["--offload-finished"],
])
def test_serve_cli_runs(argv, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device",
                      "cpu", "--requests", "4", "--max-new", "5"] + argv)
    assert len(out) == 4 and all(len(v) == 5 for v in out.values())
    text = capsys.readouterr().out
    if "--disagg" in argv:
        assert "4 handoffs" in text
    if "--prefix-cache" in argv:
        assert "prefix cache:" in text and "0 page hits" not in text


def test_serve_cli_spool_two_processes(tmp_path, capsys):
    """``--role prefill --handoff-spool`` then ``--role decode`` (one
    process each in use; here one after the other): the decode half
    emits the fused run's tokens."""
    from repro_torch.launch import serve
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4"]
    spool = ["--handoff-spool", str(tmp_path / "d.pkl")]
    first = serve.main(base + ["--role", "prefill"] + spool)
    out = serve.main(base + ["--role", "decode"] + spool)
    fused = serve.main(base)
    assert all(len(v) == 1 for v in first.values())
    assert out == fused


def _rehearsal():
    """One smoke-width layer whose pagers account the full width's page
    bytes: the engines decide as they do at full width."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    full = get_config("phi4-mini-3.8b")
    nbytes = (2 * full.num_layers * chip_smoke.ENGINE["page_size"]
              * full.num_kv_heads * full.head_dim * 2)
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), num_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return chip_smoke, cfg, params, nbytes


def test_chip_smoke_disagg_and_offload_settings():
    """Phase 3d's pair and phase 3f's offloading engine at the smoke
    width: 3d passes its gates with the FUSED engine's tokens, 3f's
    fetched caches pass theirs (shape, zeros, layer 0's K against its
    recomputation, tier entries gone)."""
    chip_smoke, cfg, params, nbytes = _rehearsal()

    def factory(pool, table, *, page_nbytes):
        return tpaging.Pager(pool, table, page_nbytes=nbytes)

    pages = chip_smoke.ENGINE["device_pages"]
    _, fused, _ = chip_smoke.serve(cfg, params, "cpu", pages,
                                   pager_factory=factory)
    pre, dec, tier, out, _ = chip_smoke.serve_disagg(cfg, params, "cpu",
                                                     pages, nbytes)
    chip_smoke.check_disagg(pre, dec, tier, out)
    assert out == fused
    eng, off, _ = chip_smoke.serve(cfg, params, "cpu", pages,
                                   offload_finished=True,
                                   pager_factory=factory)
    assert off == fused
    worst = chip_smoke.check_fetched(
        eng, cfg, params, chip_smoke.prompts(cfg.vocab_size), "cpu")
    assert worst["pages"] > 0
