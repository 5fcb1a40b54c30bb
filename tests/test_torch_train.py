"""Training of the dense family in the port against the JAX package, on
the CPU: ``forward``, ``chunked_cross_entropy``, ``train_loss`` and every
gradient, the remat policies, AdamW, and ``make_train_step``.

Configs: the SMOKE configs of h2o-danube-1.8b (a window of 8 under a
24-token sequence), phi4-mini-3.8b and qwen2-vl-72b (M-RoPE, positions
given per batch), with f32 compute; weights made by the JAX
``init_params`` and moved over by ``repro_torch.bridge``, every input
numpy-seeded.  The LM head's product is bf16 on both sides whatever the
compute dtype, as in the reference, so the gradients carry bf16 rounding
of the logits' cotangent: measured, every leaf's largest difference is
at most 4.5e-4 of its largest magnitude (danube's final norm), and the
bar is 2e-3 of it.  Losses agree to 2e-6 (measured: 1e-6); the hidden
states of ``forward``, all-f32, to 1e-5 of their largest magnitude.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.dist.steps import make_train_step as jmake_train_step
from repro.launch.mesh import make_mesh_compat
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.bridge import (grads_from_numpy, opt_state_from_numpy,
                                params_from_numpy)
from repro_torch.configs import base as tbase
from repro_torch.models import model as tmodel
from repro_torch import tree as ttree
from repro_torch.optim import adamw as tadamw
from repro_torch.steps import make_train_step

ARCHS = ("h2o-danube-1.8b", "phi4-mini-3.8b", "qwen2-vl-72b")
B, S = 2, 24
LOSS_TOL = 2e-6
GRAD_TOL = 2e-3          # of each leaf's largest magnitude
HIDDEN_TOL = 1e-5        # of the largest magnitude
ADAM_TOL = 1e-6          # params after updates, absolute (measured 6e-8)
BF16_STEP = 2.0 ** -7    # a bf16 step, relative, at the top of a binade


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree, prefix=()):
    """(path, leaf) of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def near(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|)... per leaf, the
    scale its own largest magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def trees_near(got, want, tol):
    want = dict(leaves(want))
    got = dict(leaves(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        near(got[path].detach().numpy(), w, tol, "/".join(path))


_WEIGHTS = {}


def weights(arch):
    """(JAX config, port config, JAX params, port params) of ``arch``'s
    SMOKE config with f32 compute, made once per module."""
    if arch not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   compute_dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch),
                                   compute_dtype="float32")
        jp = jax.jit(jmodel.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jcfg, tcfg, jp,
                          params_from_numpy(to_numpy(jp), "cpu"))
    return _WEIGHTS[arch]


def make_batch(cfg, seed=1, batch=B, seq=S):
    """numpy tokens and labels (-1 on a few), M-RoPE positions whose h
    and w rows differ from t."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq))}
    out["labels"][0, :3] = -1
    if cfg.mrope_sections:
        out["positions"] = np.stack([
            np.broadcast_to(np.arange(seq), (batch, seq)),
            rng.integers(0, seq, (batch, seq)),
            rng.integers(0, seq, (batch, seq))])
    return {k: v.astype(np.int32) for k, v in out.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def live(params):
    return ttree.tree_map(lambda p: p.detach().clone().requires_grad_(),
                           params)


def port_value_and_grad(params, cfg, batch, remat="block"):
    p = live(params)
    loss, metrics = tmodel.train_loss(p, cfg, batch, remat=remat)
    paths = [path for path, _ in leaves(p)]
    grads = torch.autograd.grad(loss, [x for _, x in leaves(p)])
    tree = {}
    for path, g in zip(paths, grads):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            tree)


_JAX_GRADS = {}


def jax_value_and_grad(arch, remat="block"):
    if arch not in _JAX_GRADS:
        jcfg, _, jp, _ = weights(arch)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.train_loss(p, jcfg, b, remat=remat),
            has_aux=True))
        (loss, metrics), grads = fn(jp, jax_batch(make_batch(jcfg)))
        _JAX_GRADS[arch] = (float(loss),
                            {k: float(v) for k, v in metrics.items()},
                            to_numpy(grads))
    return _JAX_GRADS[arch]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ShapeConfig", "TrainConfig"])
def test_config_dataclasses_match_reference(name):
    from repro.configs import base as jbase
    port, ref = getattr(tbase, name), getattr(jbase, name)
    assert [(f.name, f.default) for f in dataclasses.fields(port)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    if name == "ShapeConfig":
        assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
            [dataclasses.asdict(s) for s in jbase.SHAPES]
        assert tbase.SHAPES[0].tokens == jbase.SHAPES[0].tokens


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = weights(arch)
    b = make_batch(jcfg)
    jx, jaux = jax.jit(lambda p, b: jmodel.forward(p, jcfg, b, remat="none"))(
        jp, jax_batch(b))
    with torch.no_grad():
        tx, taux = tmodel.forward(tp, tcfg, torch_batch(b), remat="none")
    assert tx.dtype == torch.float32 and tuple(tx.shape) == (B, S,
                                                             jcfg.d_model)
    near(tx.numpy(), np.asarray(jx), HIDDEN_TOL, "hidden")
    assert float(taux) == float(jaux) == 0.0


def test_mrope_positions_reach_the_forward():
    """qwen2-vl's given (3, B, S) positions are used: other h / w rows
    change the hidden states, three equal rows equal no positions."""
    _, tcfg, _, tp = weights("qwen2-vl-72b")
    b = torch_batch(make_batch(tcfg))
    with torch.no_grad():
        given = tmodel.forward(tp, tcfg, b, remat="none")[0]
        text = dict(b, positions=b["positions"][:1].expand(3, B, S))
        equal = tmodel.forward(tp, tcfg, text, remat="none")[0]
        b.pop("positions")
        default = tmodel.forward(tp, tcfg, b, remat="none")[0]
    assert torch.equal(equal, default)
    assert not torch.allclose(given, default)


@pytest.mark.parametrize("z_coef", [0.0, 1e-3])
@pytest.mark.parametrize("chunk", [8, 512])
def test_chunked_cross_entropy_matches_reference(chunk, z_coef):
    """A table padded past the vocabulary (500 -> 512 rows), a logit
    scale, -1 labels, and S = 20 padded to a multiple of the chunk; value
    and the gradients of x and the table."""
    rng = np.random.default_rng(3)
    Bc, Sc, d, V = 2, 20, 32, 512
    x = rng.standard_normal((Bc, Sc, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 500, (Bc, Sc)).astype(np.int32)
    labels[1, 5:9] = -1
    kw = dict(logit_scale=0.5, chunk=chunk, z_coef=z_coef)
    jfn = jax.jit(jax.value_and_grad(
        lambda x, t: jmodel.chunked_cross_entropy(x, t, jnp.asarray(labels),
                                                  **kw), argnums=(0, 1)))
    jv, (jgx, jgt) = jfn(jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tv = tmodel.chunked_cross_entropy(tx, tt, torch.from_numpy(labels), **kw)
    tv.backward()
    assert abs(tv.item() - float(jv)) <= LOSS_TOL * abs(float(jv))
    near(tx.grad.numpy(), np.asarray(jgx), GRAD_TOL, "x")
    near(tt.grad.numpy(), np.asarray(jgt), GRAD_TOL, "table")


def test_cross_entropy_ignores_every_label():
    """All labels -1: the count clamps to 1 and the loss is 0."""
    x = torch.randn(1, 4, 8)
    table = torch.randn(16, 8)
    loss = tmodel.chunked_cross_entropy(x, table,
                                        torch.full((1, 4), -1))
    assert float(loss) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg, jp, tp = weights(arch)
    jl, jm, jg = jax_value_and_grad(arch)
    tl, tm, tg = port_value_and_grad(tp, tcfg,
                                     torch_batch(make_batch(jcfg)))
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    assert set(tm) == set(jm) == {"loss", "xent", "aux"}
    assert tm["aux"] == jm["aux"] == 0.0 and tm["loss"] == tl
    trees_near(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_loss_and_gradients(remat):
    """``none`` and ``dots`` against ``block``, bitwise: recomputation on
    the CPU repeats the same arithmetic."""
    _, tcfg, _, tp = weights("h2o-danube-1.8b")
    b = torch_batch(make_batch(tcfg))
    bl, _, bg = port_value_and_grad(tp, tcfg, b, remat="block")
    ol, _, og = port_value_and_grad(tp, tcfg, b, remat=remat)
    assert ol == bl
    for (path, g), (_, h) in zip(leaves(og), leaves(bg)):
        assert torch.equal(g, h), path


def test_dots_saves_only_the_unbatched_products():
    """The selective policy keeps what ``aten.mm`` returns and nothing
    else: under ``dots`` the backward runs the un-batched products no
    more often than without remat and recomputes the attention's batched
    ones (``aten.bmm``), which ``block`` recomputes along with every
    product."""
    _, tcfg, _, tp = weights("phi4-mini-3.8b")
    b = torch_batch(make_batch(tcfg))
    counts = {}
    for remat in ("none", "block", "dots"):
        p = live(tp)
        loss, _ = tmodel.train_loss(p, tcfg, b, remat=remat)
        with _CountProducts() as n:
            loss.backward()
        counts[remat] = n
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"][mm] == counts["none"][mm] < counts["block"][mm]
    assert counts["none"][bmm] < counts["dots"][bmm] == counts["block"][bmm]


class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ops it dispatches, by op, while active."""

    def __enter__(self):
        self.n = collections.Counter()
        super().__enter__()
        return self.n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def test_unknown_remat_raises():
    _, tcfg, _, tp = weights("phi4-mini-3.8b")
    with pytest.raises(ValueError, match="remat"):
        tmodel.train_loss(tp, tcfg, torch_batch(make_batch(tcfg)),
                          remat="full")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium",
                                  "llama4-maverick-400b-a17b", "experts"])
def test_unported_families_raise(arch):
    if arch == "experts":
        cfg = dataclasses.replace(tconfigs.get_smoke("phi4-mini-3.8b"),
                                  num_experts=4, experts_per_token=2)
    else:
        cfg = tconfigs.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="queue 1, item 1"):
        make_train_step(cfg, tbase.TrainConfig())
    with pytest.raises(NotImplementedError, match=cfg.name):
        tmodel.train_loss({}, cfg, {"tokens": torch.zeros(1, 4, dtype=int),
                                    "labels": torch.zeros(1, 4, dtype=int)})


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_three_steps_match_reference():
    """Three updates with random gradients of norm ~60 under a clip of 1:
    step 1 on the warmup's branch (lr (1 + 1) / 2), steps 2 and 3 on the
    cosine's (lr, then lr / 2); params, both moments, the step and the
    metrics."""
    jcfg, _, jp, tp = weights("phi4-mini-3.8b")
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=4, weight_decay=0.1,
               grad_clip=1.0)
    jtc, ttc = JTrainConfig(**cfg), tbase.TrainConfig(**cfg)
    rng = np.random.default_rng(5)
    jopt = jadamw.adamw_init(jp)
    topt = tadamw.adamw_init(ttree.tree_map(torch.clone, tp))
    tparams = ttree.tree_map(torch.clone, tp)
    jparams = jp
    jupdate = jax.jit(jadamw.adamw_update, static_argnums=3)
    lrs = []
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            to_numpy(jp))
        jparams, jopt, jm = jupdate(
            jax.tree_util.tree_map(jnp.asarray, g), jopt, jparams, jtc)
        tparams, topt, tm = tadamw.adamw_update(
            grads_from_numpy(g, "cpu"), topt, tparams, ttc)
        assert float(jm["grad_norm"]) > 10 * jtc.grad_clip
        near(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-6)
        near(float(tm["lr"]), float(jm["lr"]), 1e-7)
        lrs.append(float(tm["lr"]))
    assert lrs[0] == lrs[1] == pytest.approx(1e-2) and lrs[2] < lrs[1]
    assert int(topt.step) == int(jopt.step) == 3
    assert topt.step.dtype == torch.int32
    for got, want in ((tparams, jparams), (topt.m, jopt.m),
                      (topt.v, jopt.v)):
        want = dict(leaves(to_numpy(want)))
        for path, x in leaves(got):
            np.testing.assert_allclose(x.numpy(), want[path], rtol=1e-5,
                                       atol=ADAM_TOL, err_msg=str(path))


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50)
    jfn = jadamw.lr_schedule(JTrainConfig(**cfg))
    tfn = tadamw.lr_schedule(tbase.TrainConfig(**cfg))
    for s in (0, 1, 9, 10, 11, 30, 49, 50, 60):
        want = float(jfn(jnp.asarray(s, jnp.int32)))
        got = float(tfn(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * cfg["lr"] + 1e-12, s


def test_opt_state_bridge_round_trip():
    jcfg, _, jp, _ = weights("danube-smoke" and "h2o-danube-1.8b")
    jopt = jadamw.adamw_init(jp)
    jopt = jopt._replace(
        m=jax.tree_util.tree_map(lambda x: x + 1.5, jopt.m),
        step=jnp.asarray(7, jnp.int32))
    topt = opt_state_from_numpy(to_numpy(jopt.m), to_numpy(jopt.v),
                                np.asarray(jopt.step), "cpu")
    assert isinstance(topt, tadamw.OptState)
    assert int(topt.step) == 7 and topt.step.dtype == torch.int32
    for (path, x), (_, y) in zip(leaves(topt.m), leaves(to_numpy(jopt.m))):
        assert x.dtype == torch.float32 and np.array_equal(x.numpy(), y)
    g = grads_from_numpy(to_numpy(jopt.v), "cpu")
    assert [p for p, _ in leaves(g)] == [p for p, _ in leaves(topt.v)]


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

STEP_CASES = [("h2o-danube-1.8b", 1, "none"), ("h2o-danube-1.8b", 2, "none"),
              ("phi4-mini-3.8b", 2, "bf16")]


@pytest.mark.parametrize("arch,micro,compression", STEP_CASES)
def test_train_step_matches_reference(arch, micro, compression):
    """One step on a 1 x 1 mesh (JAX) and on the CPU (the port), batch 4:
    the metrics, and the updated params and moments."""
    jcfg, tcfg, jp, tp = weights(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              microbatches=micro, grad_compression=compression,
              remat="block")
    shape = tbase.ShapeConfig("t", S, 4, "train")
    from repro.configs.base import ShapeConfig as JShape
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    jstep, _ = jmake_train_step(jcfg, JTrainConfig(**kw), mesh,
                                JShape("t", S, 4, "train"), donate=False)
    b = make_batch(jcfg, seed=2, batch=4)
    jnew, jopt, jm = jstep(jp, jadamw.adamw_init(jp), jax_batch(b))
    params = ttree.tree_map(torch.clone, tp)
    step = make_train_step(tcfg, tbase.TrainConfig(**kw), shape)
    tnew, topt, tm = step(params, tadamw.adamw_init(params),
                          torch_batch(b))
    assert set(tm) == set(jm)
    for name in jm:
        near(float(tm[name]), float(jm[name]), 1e-4, name)
    assert int(topt.step) == 1
    # after one step m = (1 - b1) g: the gradients, at the gradients' bar,
    # or, cast to bf16, within a bf16 step of the leaf's largest value
    # (gradients a rounding apart may round to neighbouring bf16 values)
    tol = GRAD_TOL if compression == "none" else BF16_STEP
    trees_near(topt.m, to_numpy(jopt.m), tol)
    trees_near(topt.v, to_numpy(jopt.v), 2 * tol)
    # a first Adam step moves each weight by lr (g / (|g| + eps) + wd p),
    # whose sign a gradient near 0 flips on a rounding: held where the
    # gradient stands out of the bar's noise, 5% of the leaf's largest
    jm_tree = dict(leaves(to_numpy(jopt.m)))
    jnew = dict(leaves(to_numpy(jnew)))
    for path, x in leaves(tnew):
        m = jm_tree[path]
        firm = np.abs(m) > 0.05 * np.abs(m).max()
        assert firm.any(), path
        np.testing.assert_allclose(x.numpy()[firm], jnew[path][firm],
                                   rtol=0, atol=1e-3 * kw["lr"],
                                   err_msg=str(path))


def test_microbatch_split_refusals():
    _, tcfg, _, tp = weights("qwen2-vl-72b")
    step = make_train_step(tcfg, tbase.TrainConfig(microbatches=2))
    b = torch_batch(make_batch(tcfg, batch=2))
    params = ttree.tree_map(torch.clone, tp)
    with pytest.raises(ValueError, match="positions"):
        step(params, tadamw.adamw_init(params), b)
    with pytest.raises(ValueError, match="must divide"):
        make_train_step(tcfg, tbase.TrainConfig(microbatches=3),
                        tbase.ShapeConfig("t", S, 4, "train"))
    # one microbatch takes the positions
    step1 = make_train_step(tcfg, tbase.TrainConfig())
    _, opt, m = step1(params, tadamw.adamw_init(params), b)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))
