"""The port's model code against the JAX package on bridged weights.

Small ``phi4-mini-3.8b`` SMOKE config (3 layers, d_model 96, 6 query /
2 KV heads of 16) with f32 compute, weights made by the JAX
``init_params`` and moved over by ``repro_torch.bridge``; every input is
numpy-seeded and handed to both.  Activations and the KV pool are
compared at 1e-5 (f32 matmuls, rope and softmax sum in other orders in
the two frameworks).  These tests give both sides an f32 pool: with the
engine's bf16 pool, an f32 K/V that differs in its last bits sometimes
rounds to the neighbouring bf16 value, and one such step moved chunk
logits by 1.4e-4 in a trial run — the engine test compares tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

ATOL = RTOL = 1e-5


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


def _pool_close(jpool, tpool):
    _close(jpool, tpool.numpy())


def _f32_pools(jc, tc):
    """Swap both caches' bf16 pools for f32 zeros of the same shape."""
    shape = tuple(tc.kv["k_pages"].shape)
    jkv = dict(jc.kv, k_pages=jnp.zeros(shape, jnp.float32),
               v_pages=jnp.zeros(shape, jnp.float32))
    tkv = dict(tc.kv, k_pages=torch.zeros(shape), v_pages=torch.zeros(shape))
    return jc._replace(kv=jkv), tc._replace(kv=tkv)


def test_bridge_keeps_paths_and_shapes(setup):
    jcfg, tcfg, jparams, tparams = setup
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        t, o = tparams, own
        for k in keys:
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("name", ["dense", "rms_norm", "embed", "unembed",
                                  "rope", "swiglu"])
def test_layers_match_jax(setup, name):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    f32 = (jnp.float32, torch.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    lp_t = tmodel._layer(tparams["layers"], 0)
    if name == "dense":
        ref = jlayers.dense(lp_j["attn"]["q"], jx, f32[0])
        out = tlayers.dense(lp_t["attn"]["q"], tx, f32[1])
    elif name == "rms_norm":
        ref = jlayers.rms_norm(lp_j["attn_norm"], jx * 3.0, jcfg.norm_eps)
        out = tlayers.rms_norm(lp_t["attn_norm"], tx * 3.0, tcfg.norm_eps)
    elif name == "embed":
        toks = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
        ref = jlayers.embed(jparams["embed"], jnp.asarray(toks), f32[0])
        out = tlayers.embed(tparams["embed"], torch.from_numpy(toks), f32[1])
    elif name == "unembed":
        ref = jlayers.unembed(jparams["lm_head"], jx, compute_dtype=f32[0])
        out = tlayers.unembed(tparams["lm_head"], tx, compute_dtype=f32[1])
    elif name == "rope":
        q = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
        pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
        ref = jlayers.rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0)
        out = tlayers.rope(torch.from_numpy(q), torch.from_numpy(pos),
                           10_000.0)
    else:
        ref = jlayers.swiglu(lp_j["mlp"], jx, f32[0])
        out = tlayers.swiglu(lp_t["mlp"], tx, f32[1])
    _close(ref, out.numpy())


def _random_pools(rng, cfg, n_frames, page):
    shape = (n_frames, page, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k.copy()),
                                              torch.from_numpy(v.copy()))


def test_paged_decode_block_matches_jax(setup):
    """Output and the pool after the new token's scatter, including an
    empty slot writing the trash frame and a slot at a page edge."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    n_frames, page, pps = 9, 4, 4
    (jk, jv), (tk, tv) = _random_pools(rng, tcfg, n_frames, page)
    pt = np.full((3, pps), n_frames - 1, np.int32)
    pt[0, :2] = [3, 5]
    pt[1, :3] = [0, 1, 7]
    pos = np.array([5, 8, 0], np.int32)           # slot 2 empty
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["attn"])
    lp_t = tmodel._layer(tparams["layers"]["attn"], 1)
    ref, (jk2, jv2) = jattn.paged_decode_attention_block(
        lp_j, jcfg, jnp.asarray(x), (jk, jv), jnp.asarray(pt),
        jnp.asarray(pos), compute_dtype=jnp.float32, impl="xla")
    out = tattn.paged_decode_attention_block(
        lp_t, tcfg, torch.from_numpy(x), (tk, tv), torch.from_numpy(pt),
        torch.from_numpy(pos), compute_dtype=torch.float32)
    _close(ref, out.numpy())
    _pool_close(jk2, tk)
    _pool_close(jv2, tv)


def test_paged_prefill_block_matches_jax(setup):
    """Chunk output on valid rows and the pool after the chunk scatter:
    a row at a page-aligned offset, one starting mid-page, an inert
    length-0 row whose writes land in the trash frame."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(2)
    n_frames, page, pps, T = 11, 4, 5, 6
    (jk, jv), (tk, tv) = _random_pools(rng, tcfg, n_frames, page)
    offset = np.array([4, 2, 0], np.int32)
    length = np.array([6, 5, 0], np.int32)
    rows = np.full((3, pps), n_frames - 1, np.int32)
    rows[0, :3] = [2, 4, 6]
    rows[1, :2] = [1, 9]
    pos2 = offset[:, None] + np.arange(T, dtype=np.int32)[None, :]
    x = rng.standard_normal((3, T, tcfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[2], jparams["layers"]["attn"])
    lp_t = tmodel._layer(tparams["layers"]["attn"], 2)
    ref, (jk2, jv2) = jattn.paged_prefill_block(
        lp_j, jcfg, jnp.asarray(x), (jk, jv), jnp.asarray(rows),
        jnp.asarray(offset), jnp.asarray(length), jnp.asarray(pos2),
        compute_dtype=jnp.float32, impl="xla")
    out = tattn.paged_prefill_block(
        lp_t, tcfg, torch.from_numpy(x), (tk, tv), torch.from_numpy(rows),
        torch.from_numpy(offset), torch.from_numpy(length),
        torch.from_numpy(pos2), compute_dtype=torch.float32)
    ref = np.asarray(ref)
    for c, n in enumerate(length):
        _close(ref[c, :n], out[c, :n].numpy())
    # the trash frame takes unordered duplicate writes: compare the rest
    _pool_close(jk2[:-1], tk[:-1])
    _pool_close(jv2[:-1], tv[:-1])


def test_prefill_chunk_then_decode_step_match_jax(setup):
    """One mixed tick by hand: a prompt chunk for two admitting rows
    (logits at each row's last valid token), then a decode token for
    every slot over the pool the chunk filled."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(3)
    B, max_len, page, n_frames, T = 3, 16, 4, 10, 8
    jc = jmodel.init_paged_cache(jcfg, B, max_len, n_frames, page)
    tc = tmodel.init_paged_cache(tcfg, B, max_len, n_frames, page,
                                 device="cpu")
    jc, tc = _f32_pools(jc, tc)
    toks = rng.integers(0, tcfg.vocab_size, (2, T)).astype(np.int32)
    rows = np.full((2, max_len // page), n_frames - 1, np.int32)
    rows[0, :2] = [4, 0]
    rows[1, :2] = [2, 7]
    chunk = {"tokens": toks, "offset": np.zeros(2, np.int32),
             "length": np.array([7, 5], np.int32), "page_rows": rows}
    jl, jc, _ = jmodel.prefill_chunk(
        jparams, jcfg, jc, {k: jnp.asarray(v) for k, v in chunk.items()},
        impl="xla")
    tl, tc = tmodel.prefill_chunk(
        tparams, tcfg, tc, {k: torch.from_numpy(v) for k, v in chunk.items()})
    _close(jl, tl.numpy())
    _pool_close(jc.kv["k_pages"][:, :-1], tc.kv["k_pages"][:, :-1])

    pt = np.full((B, max_len // page), n_frames - 1, np.int32)
    pt[:2] = rows
    pos = np.array([7, 5, 0], np.int32)
    jc = jc._replace(kv=dict(jc.kv, page_table=jnp.asarray(pt)),
                     pos=jnp.asarray(pos))
    tc.kv["page_table"].copy_(torch.from_numpy(pt))
    tc = tc._replace(pos=torch.from_numpy(pos))
    dtoks = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = jmodel.decode_step(jparams, jcfg, jc, jnp.asarray(dtoks),
                                impl="xla")
    tl, tc = tmodel.decode_step(tparams, tcfg, tc, torch.from_numpy(dtoks))
    _close(jl, tl.numpy())
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())
    _pool_close(jc.kv["v_pages"][:, :-1], tc.kv["v_pages"][:, :-1])
