"""The port's MoE family against the JAX package on bridged weights.

The ``olmoe-1b-7b`` SMOKE config (2 layers, d_model 64, 4 heads of 16, 8
experts top-2 on every layer) with f32 compute, weights made by the JAX
``init_params`` and moved over by ``repro_torch.bridge``; every input is
numpy-seeded and handed to both.  The expert block, the three steps and
the serving engine are compared at f32 tolerance (1e-5, as the dense
model tests): the port sums a token's k expert rows in a fixed order
where XLA scatter-adds them, and the two frameworks' f32 products round
alike only to the last bits.  Routing is integer: the sorted pairs'
slots and drops must be equal wherever the router's top-k is decided by
more than that rounding.  The engine must give the JAX engine's greedy
tokens under preemption, as the dense engine test asks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serve import config as jconf
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine

ARCH = "olmoe-1b-7b"
ATOL = RTOL = 1e-5
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


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


def _mlp(jparams, tparams, layer):
    return (jax.tree_util.tree_map(lambda a: a[layer],
                                   jparams["layers"]["mlp"]),
            tmodel._layer(tparams["layers"]["mlp"], layer))


def test_config_is_the_reference_copy():
    from repro.configs import get_config as jax_config
    assert ARCH in ARCH_IDS
    for get, jget in ((get_config, jax_config), (get_smoke, jax_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get_config(ARCH).param_count() == jax_config(ARCH).param_count()


def test_bridge_carries_every_moe_leaf(setup):
    """Every JAX leaf crosses by path with its shape and values — the
    router's ``w`` and the expert stacks, which have no ``w`` — and the
    port's own ``init_params`` draws the same tree."""
    _, tcfg, jparams, tparams = setup
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    paths = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        t, o = tparams, own
        for k in keys:
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        paths.append(tuple(keys))
    for leaf in (("router", "w"), ("gate",), ("up",), ("down",)):
        assert ("layers", "mlp") + leaf in paths
    cast = tmodel.cast_params(tparams, torch.bfloat16, "cpu")["layers"]["mlp"]
    assert cast["router"]["w"].dtype == torch.float32
    assert {cast[n].dtype for n in ("gate", "up", "down")} == {torch.bfloat16}


@pytest.mark.parametrize("B,S,layer", [(3, 9, 0), (4, 1, 1), (2, 16, 1),
                                       (1, 5, 0)])
def test_moe_block_matches_jax(setup, B, S, layer):
    """Output and aux loss, with capacity drops (S = 9, 16) and without
    (decode, S = 1)."""
    jcfg, tcfg, jparams, tparams = setup
    x = np.random.default_rng(B * 100 + S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jp, tp = _mlp(jparams, tparams, layer)
    ref, raux = jmoe.moe_block(jp, jcfg, jnp.asarray(x),
                               compute_dtype=jnp.float32)
    out, aux = tmoe.moe_block(tp, tcfg, torch.from_numpy(x),
                              compute_dtype=torch.float32)
    assert out.shape == (B, S, tcfg.d_model) and out.dtype == torch.float32
    _close(ref, out.numpy())
    _close(raux, aux.numpy())


def test_routing_and_slots_match_jax(setup):
    """Expert sets per token, then the sorted pairs' experts, tokens,
    slots and drops, equal to the reference's wherever every token of a
    row has its k-th and (k+1)-th router probabilities further apart
    than f32 rounding; capacity 3 for 9 tokens x 2 choices drops pairs."""
    jcfg, tcfg, jparams, tparams = setup
    B, S = 6, 9
    E, k = tcfg.num_experts, tcfg.experts_per_token
    C = tmoe.expert_capacity(tcfg, S)
    x = np.random.default_rng(11).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jp, tp = _mlp(jparams, tparams, 0)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    jtop = np.asarray(jax.lax.top_k(jprobs, k + 1)[0])
    decided = (jtop[..., k - 1] - jtop[..., k] > 1e-5).all(axis=-1)   # (B,)
    assert decided.sum() >= 3
    _, _, ids = tmoe._route(tp, torch.from_numpy(x), k, True)
    jids = np.asarray(jax.lax.top_k(jprobs, k)[1])
    flat = ids.reshape(B, S * k)
    order, slot, keep = tmoe._sort_pairs(flat, E, C)
    assert not keep.all()                              # drops exercised
    pair_tok = np.repeat(np.arange(S), k)
    for b in np.flatnonzero(decided):
        assert [set(r) for r in ids[b].tolist()] == \
            [set(r) for r in jids[b].tolist()]
        row = jids[b].reshape(-1)
        jorder = jnp.argsort(row)
        jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(row)[jorder], E, C)
        se = flat[b][order[b]]
        np.testing.assert_array_equal(se.numpy(), row[np.asarray(jorder)])
        np.testing.assert_array_equal((order[b] // k).numpy(),
                                      pair_tok[np.asarray(jorder)])
        np.testing.assert_array_equal(slot[b].numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jkeep))


def test_dispatch_indices_match_jax():
    """The batched slot assignment, row by row against the reference's,
    on sorted ids with empty experts, over-full ones and ties."""
    rng = np.random.default_rng(5)
    E, C = 6, 2
    rows = np.sort(rng.integers(0, E, (4, 15)), axis=-1)
    slot, keep = tmoe._dispatch_indices(torch.from_numpy(rows), E, C)
    for b in range(4):
        js, jk = jmoe._dispatch_indices(jnp.asarray(rows[b]), E, C)
        np.testing.assert_array_equal(slot[b].numpy(), np.asarray(js))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jk))


@pytest.mark.parametrize("M,want", [(64, 8), (36, 4), (18, 2), (9, 1)])
def test_rows_per_block(M, want):
    assert tmoe.rows_per_block(M) == want


def test_moe_block_gathers_through_ops(setup, monkeypatch):
    """The dispatch gather fetches one row per capacity slot (B * E * C)
    from the tokens with a zero row appended, the combine gather one row
    per pair (B * S * k) from the expert outputs, each through
    ``ops.gather_rows`` with the model's rows_per_block."""
    _, tcfg, _, tparams = setup
    calls = []
    real = ops.gather_rows

    def spy(src, idx, **kw):
        calls.append((tuple(src.shape), idx.shape[0], kw))
        return real(src, idx, **kw)

    monkeypatch.setattr(ops, "gather_rows", spy)
    B, S, k, E = 2, 3, tcfg.experts_per_token, tcfg.num_experts
    C = tmoe.expert_capacity(tcfg, S)
    x = torch.randn(B, S, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    tmoe.moe_block(tmodel._layer(tparams["layers"]["mlp"], 0), tcfg, x,
                   compute_dtype=torch.float32, impl="torch")
    assert calls == [
        ((B * S + 1, tcfg.d_model), B * E * C,
         {"impl": "torch", "rows_per_block": tmoe.rows_per_block(B * E * C)}),
        ((B * E * C, tcfg.d_model), B * S * k,
         {"impl": "torch", "rows_per_block": tmoe.rows_per_block(B * S * k)})]


def test_dispatch_slots_hold_their_tokens(setup):
    """Each kept pair's capacity slot names its token and every other
    slot the appended zero row; the combine's rows point back at the
    same slots."""
    _, tcfg, _, tparams = setup
    B, S, k, E = 2, 5, tcfg.experts_per_token, tcfg.num_experts
    C = tmoe.expert_capacity(tcfg, S)
    p = tmodel._layer(tparams["layers"]["mlp"], 0)
    x = torch.randn(B, S, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    plan = tmoe.dispatch(p, tcfg, x)
    _, _, ids = tmoe._route(p, x, k, True)
    order, slot, keep = tmoe._sort_pairs(ids.reshape(B, S * k), E, C)
    want = torch.full((B, E * C), B * S, dtype=torch.int64)
    for b in range(B):
        for q in range(S * k):
            if keep[b, q]:
                want[b, slot[b, q]] = b * S + order[b, q] // k
    assert plan.tokens.dtype == torch.int32
    assert torch.equal(plan.tokens.long(), want.reshape(-1))
    kept = plan.weights != 0
    assert torch.equal(plan.tokens.long()[plan.slots.long()[kept]],
                       (torch.arange(B * S * k) // k)[kept])


def _caches(jcfg, tcfg, B, max_len, page, n_frames):
    """Both paged caches with f32 pools of zeros (see
    ``tests/test_torch_model.py``: a bf16 pool would round alike-looking
    K/V to neighbouring values)."""
    jc = jmodel.init_paged_cache(jcfg, B, max_len, n_frames, page)
    tc = tmodel.init_paged_cache(tcfg, B, max_len, n_frames, page,
                                 device="cpu")
    shape = tuple(tc.kv["k_pages"].shape)
    jc = jc._replace(kv=dict(jc.kv, k_pages=jnp.zeros(shape, jnp.float32),
                             v_pages=jnp.zeros(shape, jnp.float32)))
    tc = tc._replace(kv=dict(tc.kv, k_pages=torch.zeros(shape),
                             v_pages=torch.zeros(shape)))
    return jc, tc


def test_steps_match_jax(setup):
    """One prompt chunk for two rows (the second only partly filled, so
    its zero-padded tokens are routed and take capacity, as in the
    reference), then a decode token for every slot and a verify step of
    K = 2 drafts over the pool the chunk filled: logits and pools."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(3)
    B, max_len, page, n_frames, T = 3, 16, 4, 10, 8
    jc, tc = _caches(jcfg, tcfg, B, max_len, page, n_frames)
    toks = rng.integers(0, tcfg.vocab_size, (2, T)).astype(np.int32)
    rows = np.full((2, max_len // page), n_frames - 1, np.int32)
    rows[0, :2] = [4, 0]
    rows[1, :2] = [2, 7]
    chunk = {"tokens": toks, "offset": np.zeros(2, np.int32),
             "length": np.array([8, 5], np.int32), "page_rows": rows}
    jl, jc, _ = jmodel.prefill_chunk(
        jparams, jcfg, jc, {k: jnp.asarray(v) for k, v in chunk.items()},
        impl="xla")
    tl, tc, _ = tmodel.prefill_chunk(
        tparams, tcfg, tc, {k: torch.from_numpy(v) for k, v in chunk.items()})
    _close(jl, tl.numpy())
    _close(jc.kv["k_pages"][:, :-1], tc.kv["k_pages"][:, :-1].numpy())

    pt = np.full((B, max_len // page), n_frames - 1, np.int32)
    pt[:2] = rows
    pos = np.array([8, 5, 0], np.int32)
    jc = jc._replace(kv=dict(jc.kv, page_table=jnp.asarray(pt)),
                     pos=jnp.asarray(pos))
    tc.kv["page_table"].copy_(torch.from_numpy(pt))
    tc = tc._replace(pos=torch.from_numpy(pos))
    vkv = {k: v.clone() for k, v in tc.kv.items()}
    jvc = jc

    dtoks = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc2 = jmodel.decode_step(jparams, jcfg, jc, jnp.asarray(dtoks),
                                 impl="xla")
    tl, tc2 = tmodel.decode_step(tparams, tcfg, tc, torch.from_numpy(dtoks))
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(np.asarray(jc2.pos), tc2.pos.numpy())
    _close(jc2.kv["v_pages"][:, :-1], tc2.kv["v_pages"][:, :-1].numpy())

    vtoks = rng.integers(0, tcfg.vocab_size, (B, 3)).astype(np.int32)
    vlen = np.array([3, 2, 0], np.int32)
    jl, jvc = jmodel.verify_step(jparams, jcfg, jvc, jnp.asarray(vtoks),
                                 jnp.asarray(vlen), impl="xla")
    tl, tvc = tmodel.verify_step(tparams, tcfg, tc._replace(kv=vkv),
                                 torch.from_numpy(vtoks),
                                 torch.from_numpy(vlen))
    assert tl.shape == (B, 3, tcfg.padded_vocab)
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(tvc.pos.numpy(), pos)
    _close(jvc.kv["k_pages"][:, :-1], tvc.kv["k_pages"][:, :-1].numpy())


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
def engines(setup):
    jcfg, tcfg, jparams, tparams = setup
    prompts = _prompts(tcfg.vocab_size)
    jeng, jout = _serve(JaxEngine, jcfg, jparams, _econf(jconf, 10), prompts)
    teng, tout = _serve(Engine, tcfg, tparams,
                        _econf(tconf, 10, device="cpu"), prompts)
    return prompts, (jeng, jout), (teng, tout)


def test_engine_tokens_match_jax_engine(engines):
    _, (jeng, jout), (teng, tout) = engines
    assert jeng.stats["preemptions"] > 0 and jeng.stats["resumes"] > 0
    assert sorted(tout) == sorted(jout) == list(range(len(LENGTHS)))
    assert all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout


@pytest.mark.parametrize("name", COUNTERS)
def test_engine_counters_match_jax_engine(engines, name):
    _, (jeng, _), (teng, _) = engines
    assert teng.stats[name] == jeng.stats[name]


def test_engine_pager_traffic_matches_jax_engine(engines):
    _, (jeng, _), (teng, _) = engines
    assert dict(teng.pager.stats) == dict(jeng.pager.stats)
    assert teng.page_pool.n_free == teng.page_pool.n_pages


def test_oversubscribed_pool_matches_roomy_pool(setup, engines):
    """Parking and resuming pages changes no token: a chunk's capacity
    depends on its rows, never on where their pages live."""
    _, tcfg, _, tparams = setup
    prompts, _, (teng, tout) = engines
    roomy, rout = _serve(Engine, tcfg, tparams,
                         _econf(tconf, None, device="cpu"), prompts)
    assert roomy.stats["preemptions"] == 0 < teng.stats["preemptions"]
    assert rout == tout


def test_random_init_serves_smoke_config():
    cfg = get_smoke(ARCH)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng, out = _serve(Engine, cfg, params, _econf(tconf, 10, device="cpu"),
                      _prompts(cfg.vocab_size))
    assert all(len(out[r]) == MAX_NEW for r in range(len(LENGTHS)))
    assert eng.stats["preemptions"] > 0


class _Shifted:
    """Drafts the reference tokens shifted by one id: every draft after
    the first verify step of a row is rejected."""

    def __init__(self, refs, lens, k, vocab):
        self.refs, self.lens, self.k, self.vocab = refs, lens, k, vocab

    def propose(self, rid, history):
        n = len(history) - self.lens[rid]
        return [(t + 1) % self.vocab for t in self.refs[rid][n:n + self.k]]

    def drop(self, rid):
        pass


@pytest.mark.parametrize("kv_quant,drafts", [("none", "ngram"),
                                             ("none", "shifted"),
                                             ("int8", "none"),
                                             ("int8", "shifted")])
def test_speculation_and_quant_pool_serve_moe(setup, engines, kv_quant,
                                              drafts):
    """Speculative verify-K decode (K = 2) and the int8 pool on the MoE
    stack: every request finishes with its count, the speculation
    counters balance, rollback returns every page, the pool preempts."""
    _, tcfg, _, tparams = setup
    prompts, _, (_, refs) = engines
    lens = {i: len(p) for i, p in enumerate(prompts)}
    factory = (None if drafts in ("ngram", "none") else
               lambda n, k: _Shifted(refs, lens, k, tcfg.padded_vocab))
    econf = _econf(tconf, 10, device="cpu")
    econf = dataclasses.replace(
        econf,
        paging=dataclasses.replace(econf.paging, kv_quant=kv_quant),
        speculation=tconf.SpeculationConfig(
            speculate_k=0 if drafts == "none" else 2, speculate_ngram=2,
            proposer_factory=factory))
    eng, out = _serve(Engine, tcfg, tparams, econf, prompts)
    assert all(len(out[r]) == MAX_NEW for r in range(len(LENGTHS)))
    s = eng.stats
    assert s["accepted"] + s["rejected"] == s["drafted"]
    assert s["preemptions"] > 0 and s["resumes"] > 0
    if drafts == "shifted":
        assert s["spec_steps"] > 0 and s["rejected"] > 0
    if drafts != "none":
        eng.check_invariants()
    assert eng.page_pool.n_free == eng.page_pool.n_pages
    want = torch.int8 if kv_quant == "int8" else torch.bfloat16
    assert eng.cache.kv["k_pages"].dtype == want


#: the families the port still refuses: enc-dec (with each option that
#: was refused until the grouped MoE stack was ported), and the dense
#: family with experts
@pytest.mark.parametrize("change", [dict(moe_every=2, family="encdec"),
                                    dict(shared_expert=True,
                                         family="encdec"),
                                    dict(family="dense")])
def test_engine_refuses_unported_moe(change):
    cfg = dataclasses.replace(get_smoke(ARCH), **change)
    with pytest.raises(NotImplementedError):
        Engine(cfg, {}, _econf(tconf, 10, device="cpu"))
    with pytest.raises(NotImplementedError):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_chip_smoke_olmoe_settings_preempt_and_resume():
    """``chip_smoke.py`` phase 7's engine settings on olmoe-1b-7b: one
    smoke-width layer with the full width's page bytes (2,097,152, the
    same as phi4-mini's) and the 12 requests drawn over olmoe's vocab
    make the watermark engine preempt and resume, as on the card."""
    import chip_smoke
    from repro_torch.paging import Pager

    full = get_config(ARCH)
    full_nbytes = (2 * full.num_layers * chip_smoke.ENGINE["page_size"]
                   * full.num_kv_heads * full.head_dim * 2)   # bf16 K + V
    assert full_nbytes == 2_097_152

    def pager_factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=full_nbytes)

    cfg = dataclasses.replace(get_smoke(ARCH), num_layers=1,
                              vocab_size=full.vocab_size)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    econf = chip_smoke.engine_config("cpu", chip_smoke.ENGINE["device_pages"])
    econf = dataclasses.replace(econf, paging=dataclasses.replace(
        econf.paging, pager_factory=pager_factory))
    eng = Engine(cfg, params, econf)
    for p in chip_smoke.prompts(full.vocab_size):
        eng.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
    out = eng.run()
    assert len(out) == chip_smoke.N_REQUESTS
    assert all(len(v) == chip_smoke.NEW_TOKENS for v in out.values())
    assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
