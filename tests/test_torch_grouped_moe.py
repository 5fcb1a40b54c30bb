"""llama4-maverick-400b-a17b's grouped MoE stack in the port against the
JAX package on bridged weights.

The ``llama4-maverick-400b-a17b`` SMOKE config (4 layers in two groups of
a dense layer and an MoE layer, d_model 64, 4 / 2 heads of 16, 8 experts
top-1 and a shared expert) with f32 compute, weights made by the JAX
``init_params`` and moved over by ``repro_torch.bridge``.  The expert
block with its shared expert, the parameter tree, the three paged steps
(on f32 frames and on the int8 pool) and the whole-prompt prefill are
compared at 1e-5, the MoE family's tolerance (the port sums a token's
expert rows in a fixed order where XLA scatter-adds them).  Last, a CPU
rehearsal of ``chip_smoke.py`` phase 9's settings.  The engines are
``tests/test_torch_grouped_moe_engine.py``'s.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.paging import Pager
from repro_torch.serve.engine import Engine

ARCH = "llama4-maverick-400b-a17b"
ATOL = RTOL = 1e-5
K = 2


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
    jparams = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


def _jax_moe_block(p, cfg, x, compute_dtype):
    """The reference's expert block, jitted: one compile per shape
    instead of one per operation."""
    return jax.jit(jmoe.moe_block, static_argnames=("cfg", "compute_dtype"))(
        p, cfg=cfg, x=x, compute_dtype=compute_dtype)


def _moe_layer(jparams, tparams, group):
    return (jax.tree_util.tree_map(lambda a: a[group],
                                   jparams["groups"]["moe"]["mlp"]),
            tmodel._layer(tparams["groups"]["moe"]["mlp"], group))


# ---------------------------------------------------------------------------
# config, parameters, the expert block
# ---------------------------------------------------------------------------

def test_config_is_the_reference_copy():
    assert ARCH in ARCH_IDS
    for get, jget in ((get_config, jax_config), (get_smoke, jax_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert get_config(ARCH).param_count() == jax_config(ARCH).param_count()
    cfg = get_config(ARCH)
    assert (cfg.moe_every, cfg.shared_expert, cfg.num_heads
            // cfg.num_kv_heads) == (2, True, 5)
    assert tmodel.family_ported(cfg) and tmodel.family_ported(get_smoke(ARCH))


def test_init_params_tree_matches_reference(setup):
    """The port's own ``init_params`` draws the reference's tree — path
    for path and shape for shape, ``groups/dense`` (G, moe_every - 1,
    ...) and ``groups/moe`` (G, ...) with the shared expert — and every
    JAX leaf crosses the bridge by path with its values."""
    _, tcfg, jparams, tparams = setup
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    paths = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = tuple(p.key for p in path)
        t, o = tparams, own
        for k in keys:
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        paths.add(keys)

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else 1
                   for v in tree.values())
    assert count(own) == count(tparams) == len(paths)
    assert "layers" not in own
    G = tcfg.num_layers // tcfg.moe_every
    assert own["groups"]["dense"]["attn"]["q"]["w"].shape[:2] == (G, 1)
    assert own["groups"]["moe"]["mlp"]["gate"].shape[0] == G
    for leaf in ("gate", "up", "down"):
        assert ("groups", "moe", "mlp", "shared", leaf, "w") in paths
    cast = tmodel.cast_params(tparams, torch.bfloat16, "cpu")
    moe = cast["groups"]["moe"]["mlp"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["shared"]["down"]["w"].dtype == torch.bfloat16
    assert moe["up"].dtype == torch.bfloat16


def test_layer_params_walks_the_reference_layout(setup):
    """Layer l is group l // 2's dense layer (l even) or its MoE layer
    (l odd): the reference's cache layout ``g = l // moe_every, slot =
    l % moe_every``."""
    _, tcfg, jparams, tparams = setup
    for l in range(tcfg.num_layers):
        lp, is_moe = tmodel.layer_params(tparams, tcfg, l)
        g, slot = divmod(l, tcfg.moe_every)
        assert is_moe == (slot == tcfg.moe_every - 1)
        if is_moe:
            ref = jparams["groups"]["moe"]["attn"]["q"]["w"][g]
            assert "router" in lp["mlp"] and "shared" in lp["mlp"]
        else:
            ref = jparams["groups"]["dense"]["attn"]["q"]["w"][g, slot]
            assert set(lp["mlp"]) == {"gate", "up", "down"}
        np.testing.assert_array_equal(lp["attn"]["q"]["w"].numpy(),
                                      np.asarray(ref))


@pytest.mark.parametrize("B,S,group", [(3, 9, 0), (4, 1, 1), (2, 16, 1),
                                       (1, 5, 0)])
def test_moe_block_with_shared_expert_matches_jax(setup, B, S, group):
    """Output and aux loss of the expert block with its shared expert,
    with capacity drops (S = 9, 16) and without (decode, S = 1)."""
    jcfg, tcfg, jparams, tparams = setup
    x = np.random.default_rng(B * 100 + S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jp, tp = _moe_layer(jparams, tparams, group)
    ref, raux = _jax_moe_block(jp, jcfg, jnp.asarray(x), jnp.float32)
    out, aux = tmoe.moe_block(tp, tcfg, torch.from_numpy(x),
                              compute_dtype=torch.float32)
    assert out.shape == (B, S, tcfg.d_model) and out.dtype == torch.float32
    _close(ref, out.numpy())
    _close(raux, aux.numpy())
    # the shared expert is on the path: without it the block differs
    bare = dict(tp)
    del bare["shared"]
    plain, _ = tmoe.moe_block(bare, dataclasses.replace(
        tcfg, shared_expert=False), torch.from_numpy(x),
        compute_dtype=torch.float32)
    assert not torch.allclose(plain, out, atol=1e-3)


def test_moe_block_rounds_in_the_compute_dtype(setup):
    """bf16 compute: the shared expert's rows add to the combined rows in
    bf16 before the cast to x's dtype, as the reference's ``out +
    swiglu(...)`` does; the block then matches the reference at one bf16
    step."""
    jcfg, tcfg, jparams, tparams = setup
    x = np.random.default_rng(4).standard_normal(
        (2, 6, tcfg.d_model)).astype(np.float32)
    jp, tp = _moe_layer(jparams, tparams, 0)
    ref, _ = _jax_moe_block(jp, jcfg, jnp.asarray(x), jnp.bfloat16)
    out, _ = tmoe.moe_block(tp, tcfg, torch.from_numpy(x),
                            compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    _close(ref, out.numpy(), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _caches(jcfg, tcfg, B, max_len, page, n_frames, quant):
    """Both paged caches: f32 frames of zeros for "none" (a bf16 pool
    would round alike-looking K/V to neighbouring values; see
    ``tests/test_torch_model.py``), else the int8 pool with its scales."""
    if quant == "int8":
        return (jmodel.init_paged_cache(jcfg, B, max_len, n_frames, page,
                                        quant="int8"),
                tmodel.init_paged_cache(tcfg, B, max_len, n_frames, page,
                                        device="cpu", quant="int8"))
    jc = jmodel.init_paged_cache(jcfg, B, max_len, n_frames, page)
    tc = tmodel.init_paged_cache(tcfg, B, max_len, n_frames, page,
                                 device="cpu")
    shape = tuple(tc.kv["k_pages"].shape)
    jc = jc._replace(kv=dict(jc.kv, k_pages=jnp.zeros(shape, jnp.float32),
                             v_pages=jnp.zeros(shape, jnp.float32)))
    tc = tc._replace(kv=dict(tc.kv, k_pages=torch.zeros(shape),
                             v_pages=torch.zeros(shape)))
    return jc, tc


def _pools_close(jc, tc):
    """Every live frame of every layer (the trash frame excepted); an
    int8 pool's codes exactly and its scales at the tolerance."""
    for key in ("k_pages", "v_pages"):
        j = np.asarray(jc.kv[key][:, :-1])
        t = tc.kv[key][:, :-1].numpy()
        if t.dtype == np.int8:
            np.testing.assert_array_equal(j, t)
        else:
            _close(j, t)
    for key in ("k_scales", "v_scales"):
        if key in tc.kv:
            _close(jc.kv[key][:, :-1], tc.kv[key][:, :-1].numpy())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_steps_match_jax(setup, quant):
    """One prompt chunk for two rows (the second partly filled), then a
    decode token for every slot and a verify step of K = 2 drafts over
    the pool the chunk filled, through all four layers of both groups:
    logits and every layer's frames."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(3)
    B, max_len, page, n_frames, T = 3, 16, 4, 10, 8
    jc, tc = _caches(jcfg, tcfg, B, max_len, page, n_frames, quant)
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
    _pools_close(jc, tc)

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
    _pools_close(jc2, tc2)

    vtoks = rng.integers(0, tcfg.vocab_size, (B, K + 1)).astype(np.int32)
    vlen = np.array([3, 2, 0], np.int32)
    jl, jvc = jmodel.verify_step(jparams, jcfg, jvc, jnp.asarray(vtoks),
                                 jnp.asarray(vlen), impl="xla")
    tl, tvc = tmodel.verify_step(tparams, tcfg, tc._replace(kv=vkv),
                                 torch.from_numpy(vtoks),
                                 torch.from_numpy(vlen))
    assert tl.shape == (B, K + 1, tcfg.padded_vocab)
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(tvc.pos.numpy(), pos)
    _pools_close(jvc, tvc)


def test_prefill_matches_jax(setup, monkeypatch):
    """The whole-prompt dense prefill (the reference's
    ``_prefill_grouped_moe``): logits at each row's last real token and
    every layer's K/V, both dense caches in f32 for the comparison (as
    ``tests/test_torch_dense_configs.py`` holds them)."""
    jcfg, tcfg, jparams, tparams = setup
    monkeypatch.setattr(jmodel, "init_kv_cache",
                        partial(jattn.init_kv_cache, dtype=jnp.float32))
    monkeypatch.setattr(tmodel, "init_kv_cache",
                        partial(tattn.init_kv_cache, dtype=torch.float32))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    last = np.array([15, 10], np.int32)
    jl, jcache = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                max_len=24, last_pos=jnp.asarray(last))
    tl, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks),
                                max_len=24, last_pos=torch.from_numpy(last))
    _close(jl, tl.numpy())
    for key in ("k", "v"):
        assert tcache.kv[key].dtype == torch.float32
        assert tuple(tcache.kv[key].shape) == jcache.kv[key].shape
        _close(jcache.kv[key], tcache.kv[key].numpy())
    np.testing.assert_array_equal(np.asarray(jcache.pos),
                                  tcache.pos.numpy())


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py phase 9
# ---------------------------------------------------------------------------

def test_chip_smoke_phase9_settings():
    """llama4 at ``chip_smoke.LLAMA4_LAYERS`` layers has frames of
    262,144 bytes: on phase 3's pool of 448 the chunk queue preempts and
    resumes, and (c) admits all 12 prompts through the dense prefill.
    One group of the smoke width (2 layers) with the card's page bytes:
    scheduling reads shapes and page bytes only."""
    import chip_smoke
    full = get_config(ARCH)
    page = chip_smoke.ENGINE["page_size"]
    nbytes = (2 * chip_smoke.LLAMA4_LAYERS * page * full.num_kv_heads
              * full.head_dim * 2)                         # bf16 K + V
    assert nbytes == 262_144

    def factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=nbytes)

    cfg = dataclasses.replace(get_smoke(ARCH), num_layers=2,
                              compute_dtype="float32",
                              vocab_size=full.vocab_size)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ps = chip_smoke.prompts(full.vocab_size)
    counts = {}
    for tag, econf in (
            ("a", chip_smoke.engine_config(
                "cpu", chip_smoke.ENGINE["device_pages"],
                pager_factory=factory)),
            ("c", chip_smoke.dense_config("cpu", pager_factory=factory))):
        eng = Engine(cfg, params, econf)
        for p in ps:
            eng.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
        out = eng.run()
        assert len(out) == chip_smoke.N_REQUESTS
        assert all(len(v) == chip_smoke.NEW_TOKENS for v in out.values())
        counts[tag] = eng.stats
    assert counts["a"]["preemptions"] > 0 and counts["a"]["resumes"] > 0
    assert counts["c"]["prefills"] == chip_smoke.N_REQUESTS
    assert counts["c"]["chunks"] == 0
