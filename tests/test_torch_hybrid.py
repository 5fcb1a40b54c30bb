"""The hybrid family (zamba2-1.2b: Mamba2 layers and a shared attention
block) in the port against the JAX package, on the CPU.

The ``zamba2-1.2b`` SMOKE config (8 Mamba2 layers, the shared block
after every 3: two groups and a tail of 2) with f32 compute, weights
made by the JAX ``init_params`` and moved over by ``repro_torch.bridge``.
Op level at 1e-5: ``ops.ssd`` with a state in and out against the
reference's ``ssd_chunked``, the padded-T rule of the block's kernel
call, the Mamba2 block and step, ``prefill``, ``decode_step`` on the
dense and the paged cache, and ``prefill_chunk`` with its state carry.
Engine level: greedy tokens equal to the JAX engine's in each mode (the
chunk queue preempting, paged == dense, the dense prefill, the
PREFILL/DECODE pair), chunked == unchunked and paged == dense inside the
port, the parked state back bitwise, the reference's refusals, the CLI,
and a CPU rehearsal of ``chip_smoke.py`` phase 11's settings at the
smoke width with the full width's page bytes.
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
from repro.serve import disagg as jdisagg
from repro.serve import engine as jengine_mod
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.paging import Pager, PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve import disagg as tdisagg
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import extract_aux_slot

ARCH = "zamba2-1.2b"
ATOL = RTOL = 1e-5
PROMPTS = ((np.arange(8), 0), (np.arange(5), 2), (np.arange(8), 4))
MAX_NEW = 6
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted", "prefills")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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
    """The port's own draw has the reference's paths and shapes (groups
    (G, every, ...), the tail, the shared block) and its constants."""
    jcfg, tcfg, jparams, _ = setup
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(own) == _shapes(jparams)
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        _close(jparams["mamba_tail"][name], own["mamba_tail"][name].numpy())


def _ssd_inputs(seed, B=2, T=40, H=3, P=16, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = np.linspace(0.5, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    S0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, S0


@pytest.mark.parametrize("T,chunk", [(40, 8), (40, 16), (7, 16)])
def test_ssd_state_in_and_out_matches_reference(T, chunk):
    """``ops.ssd``'s plain version with ``initial_state`` and
    ``return_state`` is the reference's ``ssd_chunked`` with them (a T
    the chunk does not divide included)."""
    x, dt, A, Bm, Cm, D, S0 = _ssd_inputs(1, T=T)
    jy, jS = jax.jit(jssm.ssd_chunked, static_argnames=(
        "chunk", "return_state"))(
            *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)), chunk=chunk,
            initial_state=jnp.asarray(S0), return_state=True)
    ty, tS = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)),
                     chunk=chunk, initial_state=torch.from_numpy(S0),
                     return_state=True)
    _close(jy, ty.numpy())
    _close(jS, tS.numpy())


def test_ssd_padded_rule():
    """The block's kernel call pads a T the chunk does not divide with
    rows of dt = 0 and zero x, B, C: its output and final state are the
    unpadded plain form's, bitwise; the kernel entry point itself still
    refuses that T."""
    x, dt, A, Bm, Cm, D, S0 = (torch.from_numpy(a) for a in _ssd_inputs(
        2, T=37))
    y, S = tssm.ssd_padded(x, dt, A, Bm, Cm, D, chunk=16, initial_state=S0,
                           impl="torch")
    ry, rS = tssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=16,
                              initial_state=S0, return_state=True)
    assert y.shape == x.shape
    assert torch.equal(y, ry) and torch.equal(S, rS)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd(x, dt, A, Bm, Cm, D, impl="cuda", chunk=16)


# ---------------------------------------------------------------------------
# the Mamba2 layer and the model
# ---------------------------------------------------------------------------

def _layer(setup, l=0):
    jcfg, tcfg, jparams, tparams = setup
    jl = jax.tree_util.tree_map(lambda a: a[0, l], jparams["mamba_groups"])
    tl = tmodel._mamba_layer(tparams, tcfg, l)
    return jcfg, tcfg, jl, tl


def test_mamba2_block_and_step_match_reference(setup):
    """The full-sequence layer (from zero) and the one-token step from a
    state: the reference's ``mamba2_block`` and ``mamba2_step``."""
    jcfg, tcfg, jl, tl = _layer(setup, 1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    _close(_jit(jssm.mamba2_block, "compute_dtype")(jl, jcfg, jnp.asarray(x),
                             compute_dtype=jnp.float32),
           tssm.mamba2_seq(tl, tcfg, torch.from_numpy(x),
                           compute_dtype=torch.float32)[0].numpy())
    st = jssm.mamba2_state_init(jcfg, 2)
    S0 = rng.standard_normal(st.S.shape).astype(np.float32)
    c0 = rng.standard_normal(st.conv.shape).astype(np.float32)
    x1 = x[:, :1]
    jy, jst = _jit(jssm.mamba2_step, "compute_dtype")(jl, jcfg, jnp.asarray(x1),
                               jssm.MambaState(jnp.asarray(S0),
                                               jnp.asarray(c0)),
                               compute_dtype=jnp.float32)
    ty, tst = tssm.mamba2_step(tl, tcfg, torch.from_numpy(x1),
                               tssm.MambaState(torch.from_numpy(S0),
                                               torch.from_numpy(c0)),
                               compute_dtype=torch.float32)
    _close(jy, ty.numpy())
    _state_close(jst, tst)


def test_mamba2_seq_continues_a_state(setup):
    """A layer over a sequence in two pieces, the state carried between
    them (the chunk body), equals the layer over the whole sequence."""
    jcfg, tcfg, _, tl = _layer(setup, 0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 30, tcfg.d_model)).astype(np.float32))
    whole, st = tssm.mamba2_seq(tl, tcfg, x, compute_dtype=torch.float32)
    zero = tmodel.init_ssm_state(tcfg, 2, device="cpu")
    a, sa = tssm.mamba2_seq(tl, tcfg, x[:, :13], compute_dtype=torch.float32,
                            state=tmodel._state_of(zero, 0))
    b, sb = tssm.mamba2_seq(tl, tcfg, x[:, 13:], compute_dtype=torch.float32,
                            state=sa)
    _close(whole.numpy(), torch.cat([a, b], 1).numpy())
    _close(st.S.numpy(), sb.S.numpy())
    _close(st.conv.numpy(), sb.conv.numpy())


@pytest.fixture(scope="module")
def prefilled(setup):
    """Both packages' prefill of the same 2 x 27 prompt."""
    jcfg, tcfg, jparams, tparams = setup
    toks = _tokens(jcfg.vocab_size, 2, 27, 5)
    jl, jc = _jit(jmodel.prefill, "max_len")(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                            max_len=40)
    tl, tc = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks), max_len=40)
    return toks, (jl, jc), (tl, tc)


def test_prefill_matches_reference(setup, prefilled):
    _, (jl, jc), (tl, tc) = prefilled
    _close(jl, tl.numpy())
    _state_close(jc.ssm, tc.ssm)
    for key in ("k", "v"):
        assert tuple(tc.kv[key].shape) == tuple(jc.kv[key].shape)
        _close(np.asarray(jc.kv[key], np.float32), tc.kv[key].float().numpy(),
               atol=1e-2, rtol=1e-2)                   # a bf16 cache
    assert tc.pos.tolist() == [27, 27]


def test_decode_step_matches_reference(setup, prefilled):
    """One step from the same cache on both sides (the reference's
    prefill state and its K/V, widened to f32 so that no bf16 rounding
    of a new K/V entry separates the two): logits, every layer's state
    and the K/V written."""
    jcfg, tcfg, jparams, tparams = setup
    _, (_, jc), _ = prefilled
    jc = jc._replace(kv=dict(jc.kv, k=jc.kv["k"].astype(jnp.float32),
                             v=jc.kv["v"].astype(jnp.float32)))
    tc = tmodel.Cache(
        kv={k: torch.from_numpy(np.array(v)) for k, v in jc.kv.items()},
        ssm=type(tmodel.init_ssm_state(tcfg, 1, device="cpu"))(
            *(torch.from_numpy(np.array(a)) for a in jc.ssm)),
        cross={}, pos=torch.from_numpy(np.array(jc.pos)))
    nxt = _tokens(jcfg.vocab_size, 2, 1, 6)
    jl, jc2 = _jit(jmodel.decode_step)(jparams, jcfg, jc, jnp.asarray(nxt))
    tl, tc2 = tmodel.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
    _close(jl, tl.numpy())
    _state_close(jc2.ssm, tc2.ssm)
    _close(jc2.kv["k"], tc2.kv["k"].numpy())
    assert tc2.pos.tolist() == [28, 28]


def test_sequence_then_step_is_the_longer_sequence(setup):
    """The state a Mamba2 layer's full-sequence form hands to its step:
    the layer over T tokens, then one step, gives the layer over T + 1
    tokens' last row."""
    jcfg, tcfg, _, tl = _layer(setup, 2)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 26, tcfg.d_model)).astype(np.float32))
    _, st = tssm.mamba2_seq(tl, tcfg, x[:, :25], compute_dtype=torch.float32)
    step, _ = tssm.mamba2_step(tl, tcfg, x[:, 25:], st,
                               compute_dtype=torch.float32)
    whole, _ = tssm.mamba2_seq(tl, tcfg, x, compute_dtype=torch.float32)
    _close(whole[:, 25:].numpy(), step.numpy())


def _paged(jcfg, tcfg, n_frames=12, page=4, B=2, max_len=32):
    jc = jmodel.init_paged_cache(jcfg, B, max_len, n_frames, page)
    tc = tmodel.init_paged_cache(tcfg, B, max_len, n_frames, page,
                                 device="cpu")
    # f32 pools on both sides, so the comparison sees the algorithm
    shape = tuple(tc.kv["k_pages"].shape)
    jc = jc._replace(kv=dict(jc.kv, k_pages=jnp.zeros(shape, jnp.float32),
                             v_pages=jnp.zeros(shape, jnp.float32)))
    tc = tc._replace(kv=dict(tc.kv, k_pages=torch.zeros(shape),
                             v_pages=torch.zeros(shape)))
    return jc, tc


def test_prefill_chunk_with_carry_matches_reference(setup):
    """Two chunks of a 2-row prompt through the pool, the state carried
    from the first to the second: logits, pool and carry match the
    reference's, then a paged decode step does."""
    jcfg, tcfg, jparams, tparams = setup
    jc, tc = _paged(jcfg, tcfg)
    assert tc.kv["k_pages"].shape[0] == 2         # the shared block's G
    toks = _tokens(jcfg.vocab_size, 2, 14, 8)
    rows = np.array([[0, 1, 2, 3, 11, 11, 11, 11],
                     [4, 5, 6, 7, 11, 11, 11, 11]], np.int32)
    jcarry = jax.tree_util.tree_map(
        lambda a: jnp.zeros((jcfg.num_layers,) + a.shape, a.dtype),
        jssm.mamba2_state_init(jcfg, 2))
    tcarry = tmodel.init_ssm_state(tcfg, 2, device="cpu")
    for lo, hi in ((0, 8), (8, 14)):
        chunk = {"tokens": toks[:, lo:hi],
                 "offset": np.full((2,), lo, np.int32),
                 "length": np.full((2,), hi - lo, np.int32),
                 "page_rows": rows}
        jl, jc, jcarry = _jit(jmodel.prefill_chunk, "impl")(
            jparams, jcfg, jc, dict({k: jnp.asarray(v)
                                     for k, v in chunk.items()},
                                    ssm=jcarry), impl="xla")
        tl, tc, tcarry = tmodel.prefill_chunk(
            tparams, tcfg, tc, dict({k: torch.from_numpy(v)
                                     for k, v in chunk.items()},
                                    ssm=tcarry))
        _close(jl, tl.numpy())
        _state_close(jcarry, tcarry)
        _close(jc.kv["k_pages"][:, :-1], tc.kv["k_pages"][:, :-1].numpy())
    # graduation: the carry and the rows into the slots, then one step
    pt = np.full((2, 8), 11, np.int32)
    pt[:, :4] = rows[:, :4]
    jc = jc._replace(kv=dict(jc.kv, page_table=jnp.asarray(pt)),
                     ssm=jcarry, pos=jnp.full((2,), 14, jnp.int32))
    tc = tc._replace(kv=dict(tc.kv, page_table=torch.from_numpy(pt)),
                     ssm=tcarry, pos=torch.full((2,), 14, dtype=torch.int32))
    nxt = _tokens(jcfg.vocab_size, 2, 1, 9)
    jl, jc2 = _jit(jmodel.decode_step, "impl")(jparams, jcfg, jc, jnp.asarray(nxt),
                                 impl="xla")
    tl, tc2 = tmodel.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
    _close(jl, tl.numpy())
    _state_close(jc2.ssm, tc2.ssm)


def test_chunked_prefill_agrees_with_dense_prefill(setup):
    """Inside the port: a prompt through the pool in chunks with the
    carry gives the dense prefill's last logits and final state."""
    jcfg, tcfg, _, tparams = setup
    _, tc = _paged(jcfg, tcfg, B=1)
    toks = _tokens(tcfg.vocab_size, 1, 13, 10)
    carry = tmodel.init_ssm_state(tcfg, 1, device="cpu")
    rows = np.array([[0, 1, 2, 3, 11, 11, 11, 11]], np.int32)
    for lo, hi in ((0, 4), (4, 12), (12, 13)):
        logits, tc, carry = tmodel.prefill_chunk(tparams, tcfg, tc, {
            "tokens": torch.from_numpy(toks[:, lo:hi]),
            "offset": torch.full((1,), lo, dtype=torch.int32),
            "length": torch.full((1,), hi - lo, dtype=torch.int32),
            "page_rows": torch.from_numpy(rows), "ssm": carry})
    dense, dc = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks))
    _close(dense.numpy(), logits.numpy(), atol=1e-4, rtol=1e-4)
    for a, b in zip(dc.ssm, carry):
        _close(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_model_refusals():
    """Speculative verify is the dense and MoE families' only, as in the
    reference."""
    cfg = get_smoke(ARCH)
    cache = tmodel.PagedCache(kv={}, pos=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="speculative verify"):
        tmodel.verify_step({}, cfg, cache, torch.zeros((2, 3)),
                           torch.ones(2))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _prompts(vocab):
    return [(p + off) % vocab for p, off in PROMPTS]


def _econf(mod, *, paging=None, chunk=None, role="fused", **extra):
    """The reference tests' settings (``tests/test_mixed_step.py::
    test_mixed_step_other_families``, ``tests/test_paged_decode.py::
    test_paged_matches_dense_other_families``): 2 slots of 32, buckets
    (8,), a pool of 5 frames of 4."""
    pg = dict(page_size=4, device_pages=5, hot_tail_pages=1)
    pg.update(paging or {})
    kw = {"device": "cpu"} if mod is tconf else {}
    return mod.EngineConfig(
        max_batch=2, max_len=32, prefill_buckets=(8,), role=role,
        paging=mod.PagingConfig(**pg),
        chunking=mod.ChunkingConfig(chunk_tokens=chunk, chunk_slots=2),
        **kw, **extra)


def _jax_engine(cfg, params, econf):
    """A JAX engine whose whole-prompt prefills (keyed by length and
    family; every engine here has one ``max_len``) are shared."""
    eng = JaxEngine(cfg, params, econf)
    eng._prefills = _JAX_PREFILLS
    return eng


def _serve(engine_cls, cfg, params, econf, hook=None):
    eng = engine_cls(cfg, params, econf)
    if hook is not None:
        hook(eng)
    for p in _prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=MAX_NEW)
    return eng, eng.run()


def _residue_checks(eng):
    """Record every parked residue and hold each resumed slot's state to
    it, bitwise."""
    eng.parked_state, eng.resumed = {}, 0
    park, resume = eng._park, eng._try_finish_resumes

    def parked(req):
        park(req)
        eng.parked_state[req.rid] = [t.clone() for t in req.residue["ssm"]]

    def resumed():
        waiting = {rid: r for rid, r in eng._resuming.items()
                   if not r.mid_prefill}
        resume()
        for rid, req in waiting.items():
            if rid in eng._resuming:
                continue
            now = extract_aux_slot(eng.cache, req.slot, eng.max_batch)
            for a, b in zip(eng.parked_state[rid], now["ssm"]):
                assert torch.equal(a, b)
            eng.resumed += 1
    eng._park, eng._try_finish_resumes = parked, resumed


#: id -> (options of both engines): the reference tests' modes
MODES = {
    "dense": dict(paging={"enabled": False}),
    "chunked": dict(chunk=4),
    "paged": dict(),
}


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, tcfg, jparams, tparams = setup
    runs = {}
    for mode, kw in MODES.items():
        runs[mode] = (
            _serve(Engine, tcfg, tparams, _econf(tconf, **kw),
                   hook=_residue_checks),
            _serve(_jax_engine, jcfg, jparams, _econf(jconf, **kw)))
    return runs


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(engines, mode):
    """Greedy tokens and counters equal to the JAX engine's: the chunk
    queue with the carry (preempting mid-prefill), the dense prefill on
    the pool (preempting), and paging off."""
    (teng, tout), (jeng, jout) = engines[mode]
    assert tout == jout
    for key in COUNTERS:
        assert teng.stats[key] == jeng.stats[key], key
    if mode != "dense":
        assert teng.stats["preemptions"] > 0
        assert teng.page_pool.n_free == teng.page_pool.n_pages
    if mode == "chunked":
        assert teng.stats["chunks"] > 0 and teng.chunking


def test_engine_modes_agree_inside_the_port(engines):
    """Chunked == unchunked and paged == dense, bitwise in the tokens,
    and every resumed slot's state is the parked one."""
    outs = {mode: run[0][1] for mode, run in engines.items()}
    assert outs["chunked"] == outs["paged"] == outs["dense"]
    paged = engines["paged"][0][0]
    assert paged.resumed > 0 and paged.resumed == len(paged.parked_state)


def test_roles_match_jax_pair(setup, engines):
    """The PREFILL/DECODE pair over one shared tier: the residue (the
    slot's state) travels through the tier, and the pair gives the fused
    engine's tokens, as the JAX pair does."""
    jcfg, tcfg, jparams, tparams = setup
    outs = {}
    for mod, dis, cls, cfg, params in (
            (tconf, tdisagg, Engine, tcfg, tparams),
            (jconf, jdisagg, _jax_engine, jcfg, jparams)):
        tier = dis.make_shared_tier()
        mk = dis.tier_pager_factory(tier)
        kw = dict(paging={"pager_factory": mk, "device_pages": 16})
        pe = cls(cfg, params, _econf(mod, role="prefill", **kw))
        de = cls(cfg, params, _econf(mod, role="decode",
                                     handoff=pe.handoff, **kw))
        for p in _prompts(cfg.vocab_size):
            pe.submit(p, max_new_tokens=MAX_NEW)
        outs[mod] = dis.run_disaggregated(pe, de)
        assert pe.stats["handoffs"] == len(PROMPTS)
    assert outs[tconf] == outs[jconf] == engines["dense"][0][1]


def test_offload_finished_carries_the_state(setup, engines):
    """A finished sequence's far-tier entry holds its final state;
    ``fetch_finished`` returns it with the shared block's K/V."""
    _, tcfg, _, tparams = setup
    eng, out = _serve(Engine, tcfg, tparams, _econf(
        tconf, paging={"offload_finished": True, "device_pages": 16}))
    assert out == engines["dense"][0][1]
    cache = eng.fetch_finished(0)
    assert cache.kv["k"].shape[0] == 2
    assert [tuple(t.shape) for t in cache.ssm] == [
        (tcfg.num_layers, 1) + tuple(t.shape[2:]) for t in eng.cache.ssm]


@pytest.mark.parametrize("change", [
    dict(paging={"kv_quant": "int8"}),
    dict(chunk=4, prefix_cache=True),
    dict(speculate_k=2),
])
def test_engine_refusals_match_reference(setup, change):
    """What the reference refuses for the hybrid family raises its
    ``PagingError`` in both engines: a quantized pool, the prefix
    cache, speculation."""
    jcfg, tcfg, _, _ = setup
    change = dict(change)
    for mod, cls, cfg, err in ((tconf, Engine, tcfg, PagingError),
                               (jconf, JaxEngine, jcfg, JaxPagingError)):
        kw = dict(change)
        extra = {}
        if kw.pop("prefix_cache", False):
            extra["chunking"] = mod.ChunkingConfig(chunk_tokens=4,
                                                   prefix_cache=True)
            kw.pop("chunk")
        if "speculate_k" in kw:
            extra["speculation"] = mod.SpeculationConfig(
                speculate_k=kw.pop("speculate_k"))
        econf = dataclasses.replace(_econf(mod, **kw), **extra)
        with pytest.raises(err):
            cls(cfg, {}, econf)


def test_serve_cli_hybrid(capsys):
    out = serve_cli.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
        "--max-new", "4", "--max-len", "64", "--page-size", "4",
        "--chunk-tokens", "8"])
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    assert "recurrent state" in capsys.readouterr().out


def _rehearse_zamba2(pages, counts):
    """Serve ``chip_smoke.py`` phase 11's requests on phase 3's engine
    with zamba2-1.2b's full-width page bytes (786,432: 16 positions of 6
    shared-block layers, K and V, 32 x 64 in bf16) on ``pages`` frames,
    the card run's hooks (``chip_smoke.watch_residues``) holding every
    resume to its parked state, and pin the scheduler's ``counts``.
    Scheduling reads shapes and page bytes only, so one group of the
    smoke width makes the decisions the card run makes."""
    import chip_smoke

    full = get_config(ARCH)
    nbytes = (2 * tmodel.kv_layers(full) * chip_smoke.ENGINE["page_size"]
              * full.num_kv_heads * full.head_dim * 2)
    assert nbytes == 786_432

    def pager_factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=nbytes)

    cfg = dataclasses.replace(get_smoke(ARCH), num_layers=3)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    econf = chip_smoke.engine_config("cpu", pages,
                                     pager_factory=pager_factory)
    eng = Engine(cfg, params, econf)
    seen = {}
    chip_smoke.watch_residues(eng, seen)
    for p in chip_smoke.prompts(full.vocab_size):      # the card's lengths
        eng.submit(p % cfg.vocab_size, max_new_tokens=chip_smoke.NEW_TOKENS)
    out = eng.run()
    assert len(out) == chip_smoke.N_REQUESTS
    assert all(len(v) == chip_smoke.NEW_TOKENS for v in out.values())
    # the counts the card run must repeat (chip_smoke.py prints them)
    assert {k: eng.stats[k] for k in counts} == counts
    running = counts["preemptions"] - counts["prefill_preempts"]
    assert seen == {"slot": running, "carry": counts["prefill_preempts"]}


def test_chip_smoke_zamba2_settings_preempt_and_resume():
    """``chip_smoke.py`` phase 11 (a)'s settings: on 448 frames the chunk
    queue preempts and resumes half-prefilled requests, each resumed
    with the carry it parked."""
    import chip_smoke

    _rehearse_zamba2(chip_smoke.ENGINE["device_pages"], {
        "steps": 105, "mixed_steps": 34, "chunks": 56, "preemptions": 2,
        "prefill_preempts": 2, "resumes": 2})


def test_chip_smoke_zamba2_tight_pool_preempts_a_running_slot():
    """``chip_smoke.py`` phase 11 (e)'s settings: on
    ``ZAMBA2_TIGHT_PAGES`` (300) frames a running slot is preempted too,
    and its state comes back through ``insert_aux_slot`` as parked."""
    import chip_smoke

    assert chip_smoke.ZAMBA2_TIGHT_PAGES == 300
    _rehearse_zamba2(chip_smoke.ZAMBA2_TIGHT_PAGES, {
        "steps": 140, "mixed_steps": 37, "chunks": 56, "preemptions": 6,
        "prefill_preempts": 5, "resumes": 6})
