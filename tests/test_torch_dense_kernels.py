"""The port's kernel-level entry points against the JAX package.

``repro_torch.kernels.ops.matmul``, ``flash_attention`` and
``decode_attention`` run their plain versions on CPU tensors; each must
compute what the JAX package's kernels compute in interpret mode and on
its XLA path, on the same numpy-seeded inputs, at the reference's own
bars (``tests/test_kernels.py``): relative error (max |err| / max |ref|)
under 5e-6 in f32, 2e-2 (matmul) and 3e-2 (flash) in bf16.  The XLA path
of ``flash_attention`` drops ``q_offset`` and ``kv_valid``
(``repro/kernels/ops.py:63-66``), so those are held against interpret
mode only.  Also here: the copied SPM planner against the reference's,
the kernel's tile rules, the ported quickstart, and dispatch.
"""

import contextlib
import io
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import spm as jspm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.amu_matmul import amu_matmul as jamu_matmul
from repro_torch.core import spm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.amu_matmul import k_substep, launch_tiles, plan_tiles
from repro_torch.kernels.build import HEAD_DIMS, check_heads
from repro_torch.launch import quickstart

ROOT = Path(__file__).resolve().parents[1]
H100_SMEM = 232448      # shared memory a block may opt in to on an H100


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(out, expected):
    out = np.asarray(out, np.float32)
    expected = np.asarray(expected, np.float32)
    denom = max(1e-6, float(np.abs(expected).max()))
    return float(np.abs(out - expected).max()) / denom


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (128, 128, 128, 128, 128, 128),       # single tile, n_k == 1
    (256, 256, 256, 128, 128, 128),       # n_k == 2 (both slots, no refill)
    (256, 512, 384, 128, 128, 128),       # deep pipeline, refills
    (384, 768, 128, 128, 256, 128),       # non-square blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_jax(M, K, N, bm, bk, bn, dtype):
    rng = np.random.default_rng(M + K + N)
    jx, tx = _both(rng.standard_normal((M, K)).astype(np.float32), dtype)
    jw, tw = _both(rng.standard_normal((K, N)).astype(np.float32), dtype)
    out = ops.matmul(tx, tw, bm=bm, bk=bk, bn=bn)
    assert out.dtype == tx.dtype and out.shape == (M, N)
    tol = 5e-6 if dtype == "float32" else 2e-2
    assert _rel_err(_np(out), jamu_matmul(jx, jw, bm=bm, bk=bk, bn=bn)) < tol
    assert _rel_err(_np(out), jref.matmul_ref(jx, jw)) < tol
    assert plan_tiles(M, K, N, tx.element_size(), H100_SMEM,
                      bm, bk, bn) == (bm, bk, bn)


def _qkv(rng, B, H, Hkv, Sq, Skv, D, dtype):
    return [_both(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window", [
    (1, 8, 2, 192, 192, 128, True, 48),    # GQA 4:1 + SWA + full lane D
    (1, 2, 2, 128, 256, 64, False, 0),     # cross (non-causal, Skv != Sq)
    (1, 4, 4, 256, 256, 32, True, 0),      # D = 32
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(B, H, Hkv, Sq, Skv, D, causal, window,
                                 dtype):
    rng = np.random.default_rng(Sq + Skv + D)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, B, H, Hkv, Sq, Skv, D, dtype)
    out = _np(ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  bq=64, bkv=64))
    tol = 5e-6 if dtype == "float32" else 3e-2
    for impl in ("interpret", "xla"):
        expected = jops.flash_attention(jq, jk, jv, causal=causal,
                                        window=window, impl=impl, bq=64,
                                        bkv=64)
        assert _rel_err(out, expected) < tol, impl
    assert _rel_err(out, _np(ref.attention_ref(
        tq, tk, tv, causal=causal, window=window))) < tol


@pytest.mark.parametrize("q_offset,kv_valid,window", [
    (128, 160, 0),       # a prompt chunk deep in the cache, short kv_valid
    (64, 200, 48),       # the same under a sliding window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_offsets_match_interpret(q_offset, kv_valid, window,
                                             dtype):
    rng = np.random.default_rng(q_offset + kv_valid)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 4, 2, 64, 256, 64, dtype)
    out = _np(ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                  q_offset=q_offset, kv_valid=kv_valid))
    expected = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                    impl="interpret", q_offset=q_offset,
                                    kv_valid=kv_valid, bq=64, bkv=64)
    tol = 5e-6 if dtype == "float32" else 3e-2
    assert _rel_err(out, expected) < tol
    # the same function as the naive oracle on K/V cut at kv_valid
    naive = ref.attention_ref(tq, tk[:, :kv_valid], tv[:, :kv_valid],
                              causal=True, window=window, q_offset=q_offset)
    assert _rel_err(out, _np(naive)) < tol


@pytest.mark.parametrize("B,H,Hkv,S,D,valid,bkv", [
    (2, 8, 2, 512, 64, 512, 128),
    (1, 4, 4, 256, 128, 200, 128),
    (2, 16, 4, 256, 64, 33, 64),           # short valid prefix
    (1, 8, 8, 1024, 64, 1000, 256),        # MHA long cache
])
def test_decode_plain_matches_jax(B, H, Hkv, S, D, valid, bkv):
    rng = np.random.default_rng(S + valid)
    jq, tq = _both(rng.standard_normal((B, H, D)).astype(np.float32),
                   "float32")
    jk, tk = _both(rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
                   "float32")
    jv, tv = _both(rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
                   "float32")
    out = _np(ops.decode_attention(tq, tk, tv, valid_len=valid, bkv=bkv))
    for impl in ("interpret", "xla"):
        expected = jops.decode_attention(jq, jk, jv, valid_len=valid,
                                         impl=impl, bkv=bkv)
        assert _rel_err(out, expected) < 5e-6, impl


_PLAN_SHAPES = [(256, 512, 256), (512, 3072, 8192), (8, 128, 64),
                (1024, 4096, 1024)]
_BUDGETS = [None, H100_SMEM, 64 * 1024]


def _plan_fields(fn, *args, **kw):
    try:
        p = fn(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)
    return p.block_shapes, p.buffers, p.vmem_bytes, p.pipeline_depth


@pytest.mark.parametrize("planner", ["matmul", "attention"])
def test_spm_planners_match_reference(planner):
    """Same plans (or the same refusal) for every shape, dtype width and
    budget of a small grid, the reference's default budget included."""
    name = f"plan_{planner}_blocks"
    mine, theirs = getattr(spm, name), getattr(jspm, name)
    assert spm.VMEM_BYTES == jspm.VMEM_BYTES
    for shape in _PLAN_SHAPES:
        args = shape if planner == "matmul" else (shape[0], shape[2],
                                                  min(shape[1], 256))
        for dtype_bytes in (2, 4):
            for budget in _BUDGETS:
                kw = {"dtype_bytes": dtype_bytes}
                if budget is not None:
                    kw["vmem_budget"] = budget
                assert _plan_fields(mine, *args, **kw) \
                    == _plan_fields(theirs, *args, **kw), (args, kw)


def test_kernel_tiles_and_substeps():
    """The planner's tiles at the main path's shapes, the quickstart's
    f32 128^3 split into two K sub-steps, and the refusals."""
    assert plan_tiles(512, 3072, 8192, 2, H100_SMEM) == (64, 128, 256)
    assert plan_tiles(512, 8192, 3072, 2, H100_SMEM) == (64, 128, 256)
    assert k_substep(64, 128, 256, 2, H100_SMEM) == 128
    # two f32 slots of 128^3 need 256 KiB: two sub-steps of 64 columns
    assert k_substep(128, 128, 128, 4, H100_SMEM) == 64
    with pytest.raises(ValueError, match="must tile"):
        plan_tiles(256, 512, 384, 4, H100_SMEM, 128, 128, 256)
    with pytest.raises(AssertionError, match="must tile"):
        jamu_matmul(jnp.zeros((256, 512)), jnp.zeros((512, 384)), bm=128,
                    bk=128, bn=256)
    with pytest.raises(ValueError, match="cannot hold"):
        k_substep(256, 128, 256, 2, H100_SMEM)
    with pytest.raises(ValueError, match="cannot hold"):
        k_substep(60, 128, 128, 4, H100_SMEM)


def test_f32_matmul_plans_without_tiles():
    """f32 at 1024^3 plans with no tiles given, as the reference does:
    the plain version equals the JAX XLA path and the JAX kernel run on
    its own plan (interpret mode) at the f32 bar."""
    rng = np.random.default_rng(1024)
    jx, tx = _both(rng.standard_normal((1024, 1024)).astype(np.float32),
                   "float32")
    jw, tw = _both(rng.standard_normal((1024, 1024)).astype(np.float32),
                   "float32")
    out = _np(ops.matmul(tx, tw, impl="torch"))
    assert _rel_err(out, jops.matmul(jx, jw, impl="xla")) < 5e-6
    assert _rel_err(out, jamu_matmul(jx, jw)) < 5e-6
    assert plan_tiles(1024, 1024, 1024, 4, H100_SMEM) \
        == (512, 512, 1024)


@pytest.mark.parametrize("M,K,N,tiles", [
    (1024, 1024, 1024, None), (2048, 2048, 2048, None),
    (4096, 4096, 4096, None),                      # the reference's plans
    (1024, 1024, 1024, (512, 512, 1024)),          # explicit, as planned
    (512, 1024, 2048, (512, 256, 1024)),
    (512, 3072, 8192, None),                       # bf16 and f32 main path
])
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_launch_tiles_hold_the_reference_tiles(M, K, N, tiles, dtype_bytes):
    """The reference's tiles, planned or given, map to a launch tile the
    kernel holds: it divides them, takes at most 256 threads of 8 x 8
    outputs, and ``k_substep`` accepts it; a tile the kernel holds maps to
    itself (the bf16 main path's (64, 128, 256) stays as it was)."""
    bm, bk, bn = plan_tiles(M, K, N, dtype_bytes, H100_SMEM,
                            *(tiles or (None,) * 3))
    if tiles is None:
        ref_plan = jspm.plan_matmul_blocks(M, K, N, dtype_bytes=dtype_bytes)
        assert (bm, bk, bn) in {(64, 128, 256), (
            ref_plan.block_shapes["x"][0], ref_plan.block_shapes["x"][1],
            ref_plan.block_shapes["w"][1])}
    tm, tn, bks = launch_tiles(bm, bk, bn, dtype_bytes, H100_SMEM)
    assert bm % tm == 0 and bn % tn == 0 and tm % 8 == 0 and tn % 8 == 0
    assert (tm // 8) * (tn // 8) <= 256
    assert k_substep(tm, bk, tn, dtype_bytes, H100_SMEM) == bks
    assert bk % bks == 0 and 2 * (tm + tn) * bks * dtype_bytes <= H100_SMEM
    if (bm // 8) * (bn // 8) <= 256:
        assert (tm, tn) == (bm, bn)
    if (M, K, N, dtype_bytes) == (512, 3072, 8192, 2):
        assert (bm, bk, bn, tm, tn, bks) == (64, 128, 256, 64, 256, 128)
    with pytest.raises(ValueError, match="cannot hold"):
        launch_tiles(4, bk, bn, dtype_bytes, H100_SMEM)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_attention_kernels_take_the_configs_heads(arch):
    """The heads of every registered config, full and SMOKE (G 1, 2, 3,
    4, 5, 8, 12; D 16, 32, 64, 80, 128), pass the attention kernels'
    shape check; a head dim outside the set and unequal groups raise."""
    for cfg in (jconfigs.get_config(arch), jconfigs.get_smoke(arch)):
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        check_heads(H, Hkv, D)
        for G in (1, 2, 3, 4, 5, 8, 12):
            check_heads(G * Hkv, Hkv, D)
        with pytest.raises(ValueError, match="head_dim"):
            check_heads(H, Hkv, 96)
        with pytest.raises(ValueError, match="groups"):
            check_heads(H + 1, Hkv, D)
    assert HEAD_DIMS == (16, 32, 64, 80, 128)


def _part1_lines(text):
    return text.split("== kernel AMU")[0].strip().splitlines()


def test_quickstart_matches_reference_on_cpu():
    mine = io.StringIO()
    with contextlib.redirect_stdout(mine):
        res = quickstart.main(["--device", "cpu"])
    theirs = io.StringIO()
    with contextlib.redirect_stdout(theirs):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    assert _part1_lines(mine.getvalue()) == _part1_lines(theirs.getvalue())
    assert res["runtime"]["issued"] == 8
    assert res["runtime"]["granules"] == (2048, 16)
    assert res["kernel"]["shape"] == (256, 256)
    assert res["kernel"]["rel_err"] < 5e-6


def test_dispatch():
    x, w = torch.zeros(128, 128), torch.zeros(128, 128)
    q, kv = torch.zeros(1, 64, 2, 32), torch.zeros(1, 64, 2, 32)
    qd = torch.zeros(1, 2, 32)
    for call in (lambda: ops.matmul(x, w, impl="cuda"),
                 lambda: ops.flash_attention(q, kv, kv, impl="cuda"),
                 lambda: ops.decode_attention(qd, kv, kv, impl="cuda")):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.matmul(x, w, impl="pallas")
    with pytest.raises(ValueError, match="kv_valid"):
        ops.flash_attention(q, kv, kv, kv_valid=0)
    # auto on CPU tensors is the plain version
    assert torch.equal(ops.matmul(x + 1, w + 2), ops.matmul(
        x + 1, w + 2, impl="torch"))
    assert {k.name for k in ops.DENSE_KERNELS} == {
        f"{n}_{t}" for n in ("amu_matmul", "flash_attention",
                             "decode_attention") for t in ("f32", "bf16")}
    assert not {k.name for k in ops.DENSE_KERNELS} & {
        k.name for k in ops.KERNELS}
