"""The SSM family (rwkv6-7b: RWKV-6 "Finch") in the port against the JAX
package, on the CPU.

The ``rwkv6-7b`` SMOKE config (3 layers of 128, 4 heads of 32) with f32
compute, weights made by the JAX ``init_params`` and moved over by
``repro_torch.bridge``.  Op level at 1e-5: ``ops.wkv6`` with a state in
and out against the reference's ``wkv6_chunked``, the padded-T rule of
the block's kernel call, the time mix, the channel mix, the block and
the one-token step, ``prefill`` and ``decode_step``, and the state a
prefill hands to the step.  Engine level: the engine serves the family
without a pool (it has no KV), with exact-length dense prefills, and
its greedy tokens equal the JAX engine's; the reference's refusals
raise its ``PagingError`` in both engines; the CLI serves the arch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.paging import PagingError as JaxPagingError
from repro.serve import config as jconf
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.paging import PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine

ARCH = "rwkv6-7b"
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these engines run small tensors, and the
    test runner's workers share the host's cores."""
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
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _rel_err(out, ref):
    """The reference's bar for its recurrences (``tests/test_kernels.py``
    ``_rel_err``): max |error| over max |value|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max()) / max(1e-6,
                                                float(np.abs(ref).max()))


def _state_close(jstate, tstate):
    """Every leaf of a recurrent state within the reference's
    recurrence bar, 1e-5 of its largest value."""
    for a, b in zip(jax.tree_util.tree_leaves(jstate), tstate):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel_err(b.numpy(), a) < ATOL


def _jit(fn, *static):
    """The reference function ``fn`` jitted, ``cfg`` (its second
    argument) and the keywords ``static`` static: one compile instead of
    an eager dispatch of every operation."""
    return jax.jit(fn, static_argnums=(1,), static_argnames=static)


def _tokens(vocab, B, T, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# config, parameters, the recurrence with a state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_matches_reference(which):
    port = (get_config if which == "config" else get_smoke)(ARCH)
    ref = (jax_config if which == "config" else jax_smoke)(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def test_init_params_tree_matches_reference(setup):
    """The port's own draw has the reference's paths, shapes and
    constants (the lerps, the decay's base, the norms)."""
    _, tcfg, jparams, _ = setup
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(own) == _shapes(jparams)
    for path in (("mu", "w"), ("cm_mu", "k"), ("w0",), ("ln1", "bias"),
                 ("gn", "scale")):
        j, t = jparams["layers"], own["layers"]
        for key in path:
            j, t = j[key], t[key]
        _close(j, t.numpy())


def _wkv6_inputs(seed, B=2, T=40, H=3, K=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    w = -np.exp(rng.standard_normal((B, T, H, K)) - 2).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    S0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, w, u, S0


@pytest.mark.parametrize("T,chunk", [(40, 8), (40, 16), (7, 16)])
def test_wkv6_state_in_and_out_matches_reference(T, chunk):
    """``ops.wkv6``'s plain version with ``initial_state`` and
    ``return_state`` is the reference's ``wkv6_chunked`` with them (a T
    the chunk does not divide included)."""
    r, k, v, w, u, S0 = _wkv6_inputs(1, T=T)
    jo, jS = jax.jit(jssm.wkv6_chunked, static_argnames=(
        "chunk", "return_state"))(
            *(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk,
            initial_state=jnp.asarray(S0), return_state=True)
    to, tS = ops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                      chunk=chunk, initial_state=torch.from_numpy(S0),
                      return_state=True)
    _close(jo, to.numpy())
    _close(jS, tS.numpy())


def test_wkv6_padded_rule():
    """The block's kernel call pads a T the chunk does not divide with
    zero rows of r, k, v and w: its output and final state are the
    unpadded plain form's, bitwise; the kernel entry point itself still
    refuses that T."""
    r, k, v, w, u, S0 = (torch.from_numpy(a) for a in _wkv6_inputs(2, T=37))
    o, S = tssm.wkv6_padded(r, k, v, w, u, chunk=16, initial_state=S0,
                            impl="torch")
    ro, rS = tssm.wkv6_chunked(r, k, v, w, u, chunk=16, initial_state=S0,
                               return_state=True)
    assert o.shape == v.shape
    assert torch.equal(o, ro) and torch.equal(S, rS)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.wkv6(r, k, v, w, u, impl="cuda", chunk=16)


# ---------------------------------------------------------------------------
# the RWKV6 layer and the model
# ---------------------------------------------------------------------------

def _layer(setup, l=0):
    jcfg, tcfg, jparams, tparams = setup
    jl = jax.tree_util.tree_map(lambda a: a[l], jparams["layers"])
    tl = tmodel._layer(tparams["layers"], l)
    return jcfg, tcfg, jl, tl


def test_time_and_channel_mix_match_reference(setup):
    """The time mix from a state (x_prev and the wkv state in, the final
    state out), the channel mix from x_prev, and the block from zero."""
    jcfg, tcfg, jl, tl = _layer(setup, 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    S0 = rng.standard_normal((2, jcfg.num_heads, jcfg.head_dim,
                              jcfg.head_dim)).astype(np.float32)
    jo, jS = _jit(jssm.rwkv6_time_mix, "return_state", "compute_dtype")(
        jl, jcfg, jnp.asarray(x),
                                 x_prev=jnp.asarray(xp),
                                 state=jnp.asarray(S0), return_state=True,
                                 compute_dtype=jnp.float32)
    to, tS = tssm.rwkv6_time_mix(tl, tcfg, torch.from_numpy(x),
                                 x_prev=torch.from_numpy(xp),
                                 state=torch.from_numpy(S0),
                                 return_state=True,
                                 compute_dtype=torch.float32)
    _close(jo, to.numpy())
    _close(jS, tS.numpy())
    _close(_jit(jssm.rwkv6_channel_mix, "compute_dtype")(jl, jcfg, jnp.asarray(x),
                                  x_prev=jnp.asarray(xp),
                                  compute_dtype=jnp.float32),
           tssm.rwkv6_channel_mix(tl, tcfg, torch.from_numpy(x),
                                  x_prev=torch.from_numpy(xp),
                                  compute_dtype=torch.float32).numpy())
    _close(_jit(jssm.rwkv6_block, "compute_dtype")(jl, jcfg, jnp.asarray(x),
                            compute_dtype=jnp.float32),
           tssm.rwkv6_block(tl, tcfg, torch.from_numpy(x),
                            compute_dtype=torch.float32).numpy())


def test_step_matches_reference(setup):
    jcfg, tcfg, jl, tl = _layer(setup, 2)
    rng = np.random.default_rng(4)
    st = jssm.rwkv6_state_init(jcfg, 2)
    leaves = [rng.standard_normal(a.shape).astype(np.float32) for a in st]
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jy, jst = _jit(jssm.rwkv6_step, "compute_dtype")(
        jl, jcfg, jnp.asarray(x), jssm.RWKVState(
        *(jnp.asarray(a) for a in leaves)), compute_dtype=jnp.float32)
    ty, tst = tssm.rwkv6_step(tl, tcfg, torch.from_numpy(x), tssm.RWKVState(
        *(torch.from_numpy(a) for a in leaves)), compute_dtype=torch.float32)
    _close(jy, ty.numpy())
    _state_close(jst, tst)


def test_block_continues_a_state(setup):
    """The block over a sequence in two pieces, the state carried
    between them, equals the block over the whole sequence."""
    _, tcfg, _, tl = _layer(setup, 0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 30, tcfg.d_model)).astype(np.float32))
    whole, st = tssm.rwkv6_block(tl, tcfg, x, return_state=True,
                                 compute_dtype=torch.float32)
    zero = tmodel._state_of(tmodel.init_ssm_state(tcfg, 2, device="cpu"), 0)
    a, sa = tssm.rwkv6_block(tl, tcfg, x[:, :13], state=zero,
                             return_state=True, compute_dtype=torch.float32)
    b, sb = tssm.rwkv6_block(tl, tcfg, x[:, 13:], state=sa,
                             return_state=True, compute_dtype=torch.float32)
    _close(whole.numpy(), torch.cat([a, b], 1).numpy())
    for p, q in zip(st, sb):
        _close(p.numpy(), q.numpy())


@pytest.fixture(scope="module")
def prefilled(setup):
    jcfg, tcfg, jparams, tparams = setup
    toks = _tokens(jcfg.vocab_size, 2, 27, 6)
    jl, jc = _jit(jmodel.prefill, "max_len")(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                            max_len=40)
    tl, tc = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks), max_len=40)
    return (jl, jc), (tl, tc)


def test_prefill_matches_reference(prefilled):
    (jl, jc), (tl, tc) = prefilled
    _close(jl, tl.numpy())
    _state_close(jc.ssm, tc.ssm)
    assert tc.kv == {} and tc.pos.tolist() == [27, 27]


def test_decode_step_matches_reference(setup, prefilled):
    """One step from each side's prefill: logits and every layer's state
    (S, and the last inputs of the two mixes)."""
    jcfg, tcfg, jparams, tparams = setup
    (_, jc), (_, tc) = prefilled
    nxt = _tokens(jcfg.vocab_size, 2, 1, 7)
    jl, jc2 = _jit(jmodel.decode_step)(jparams, jcfg, jc, jnp.asarray(nxt))
    tl, tc2 = tmodel.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
    _close(jl, tl.numpy())
    _state_close(jc2.ssm, tc2.ssm)
    assert tc2.pos.tolist() == [28, 28]


def test_prefill_then_step_is_the_longer_prefill(setup):
    """The state handed from the prefill to the step: prefill(T) and one
    decode step give prefill(T + 1)'s last logits."""
    _, tcfg, _, tparams = setup
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, 1, 26, 8))
    _, cache = tmodel.prefill(tparams, tcfg, toks[:, :25])
    step, _ = tmodel.decode_step(tparams, tcfg, cache, toks[:, 25:])
    whole, _ = tmodel.prefill(tparams, tcfg, toks)
    _close(whole.numpy(), step.numpy())


def test_model_refusals():
    """No KV to page and no speculative verify, as in the reference."""
    cfg = get_smoke(ARCH)
    with pytest.raises(ValueError, match="no KV to page"):
        tmodel.init_paged_cache(cfg, 2, 32, 9, 4, device="cpu")
    paged = tmodel.PagedCache(kv={}, pos=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no KV to page"):
        tmodel.decode_step({"embed": {"table": torch.zeros(8, 4)}}, cfg,
                           paged, torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="no KV to page"):
        tmodel.prefill_chunk({}, cfg, paged, {})
    with pytest.raises(ValueError, match="speculative verify"):
        tmodel.verify_step({}, cfg, paged, torch.zeros((2, 3)),
                           torch.ones(2))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _econf(mod, **kw):
    """``tests/test_serve.py::test_engine_ssm_family``'s settings: 2
    slots of 32, the port's ``chunk_tokens`` unset as the reference's
    default is."""
    extra = ({"device": "cpu",
              "chunking": tconf.ChunkingConfig(chunk_tokens=None)}
             if mod is tconf else {})
    return mod.EngineConfig(max_batch=2, max_len=32, **extra, **kw)


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, tcfg, jparams, tparams = setup
    runs = {}
    for side, mod, cls, cfg, params in (
            ("torch", tconf, Engine, tcfg, tparams),
            ("jax", jconf, JaxEngine, jcfg, jparams)):
        eng = cls(cfg, params, _econf(mod))
        for i in range(3):
            eng.submit(np.arange(4 + i), max_new_tokens=4)
        runs[side] = (eng, eng.run())
    return runs


def test_engine_matches_jax_engine(engines):
    """No pool (the family has no KV, so paging resolves to off), one
    exact-length dense prefill per request, and the JAX engine's greedy
    tokens and counters."""
    teng, tout = engines["torch"]
    jeng, jout = engines["jax"]
    assert len(tout) == 3 and all(len(v) == 4 for v in tout.values())
    assert tout == jout
    assert not teng.paging and teng.page_pool is None
    for key in ("prefills", "steps", "admitted", "chunks"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["prefills"] == 3 and teng.buckets
    assert [teng._bucket(n) for n in (4, 5, 6)] == [4, 5, 6]


def test_paging_enabled_still_serves_without_a_pool(setup, engines):
    """``paging.enabled=True`` and chunking asked for: still no pool
    (the reference's rule), the same tokens."""
    _, tcfg, _, tparams = setup
    eng = Engine(tcfg, tparams, tconf.EngineConfig(
        max_batch=2, max_len=32, device="cpu",
        paging=tconf.PagingConfig(enabled=True),
        chunking=tconf.ChunkingConfig(chunk_tokens=4)))
    assert not eng.paging and not eng.chunking
    for i in range(3):
        eng.submit(np.arange(4 + i), max_new_tokens=4)
    assert eng.run() == engines["torch"][1]


@pytest.mark.parametrize("change", [
    dict(paging="kv_quant"),
    dict(paging="offload_finished"),
    dict(role="prefill"),
    dict(role="decode"),
    dict(chunking="prefix_cache"),
    dict(speculation="speculate_k"),
])
def test_engine_refusals_match_reference(setup, change):
    """What the reference refuses for the SSM family (everything that
    needs a pool) raises its ``PagingError`` in both engines."""
    jcfg, tcfg, _, _ = setup
    (field, value), = change.items()
    for mod, cls, cfg, err in ((tconf, Engine, tcfg, PagingError),
                               (jconf, JaxEngine, jcfg, JaxPagingError)):
        econf = _econf(mod)
        if field == "role":
            econf = dataclasses.replace(econf, role=value)
        elif field == "paging":
            econf = dataclasses.replace(econf, paging=dataclasses.replace(
                econf.paging, **{value: "int8" if value == "kv_quant"
                                 else True}))
        elif field == "chunking":
            econf = dataclasses.replace(econf, chunking=mod.ChunkingConfig(
                chunk_tokens=4, prefix_cache=True))
        else:
            econf = dataclasses.replace(
                econf, speculation=mod.SpeculationConfig(speculate_k=2))
        with pytest.raises(err):
            cls(cfg, {}, econf)


def test_serve_cli_rwkv6(capsys):
    out = serve_cli.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
        "--max-new", "4", "--max-len", "64"])
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    text = capsys.readouterr().out
    assert "recurrent state" in text and "dense prefills 3" in text
