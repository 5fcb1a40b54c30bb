"""The port's plain kernel versions against the JAX package's kernels.

Each plain PyTorch version in ``repro_torch.kernels`` must compute what
the JAX package's ``kernels.ops`` computes, both on its XLA path
(``impl="xla"``) and through the Pallas kernel body in interpret mode
(``impl="interpret"``), on the same numpy-seeded inputs.  Bars are the
reference's own: 1e-5 for decode and 2e-6 for prefill
(``tests/test_mixed_step.py``).  Chunk rows at or past ``length`` are
don't-care on both sides and are not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

N, PAGE, HKV, D, H = 9, 4, 2, 16, 6          # G = 3, trash frame N - 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(rng, dtype):
    k = rng.standard_normal((N, PAGE, HKV, D)).astype(np.float32)
    v = rng.standard_normal((N, PAGE, HKV, D)).astype(np.float32)
    if dtype == "bfloat16":     # the engine's pool dtype; round once
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    return k, v


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_jax(impl, pool_dtype):
    """Ragged lengths on and across page edges (1, 4, 5, 13, 20 = the
    whole table), GQA with 3 query heads per KV head, unused table
    entries on the trash frame."""
    rng = np.random.default_rng(0)
    lengths = np.array([1, 4, 5, 13, 20], np.int32)
    B, pps = len(lengths), 5
    kp, vp = _pool(rng, pool_dtype)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pt = np.full((B, pps), N - 1, np.int32)
    for b, n in enumerate(lengths):
        used = -(-n // PAGE)
        pt[b, :used] = rng.permutation(N - 1)[:used]
    jk, tk = _both(kp, pool_dtype)
    jv, tv = _both(vp, pool_dtype)
    ref = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lengths),
        impl=impl))
    out = ops.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lengths))
    assert out.dtype == torch.float32 and out.shape == (B, H, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_prefill_plain_matches_jax(impl, window, pool_dtype):
    """Chunk rows at different depths: a full chunk at a page-aligned
    offset, a ragged chunk at offset 0, one starting mid-page, and an
    inert length-0 row; padded tails are not compared."""
    rng = np.random.default_rng(1)
    C, T, pps = 4, 8, 6
    offset = np.array([8, 0, 3, 0], np.int32)
    length = np.array([8, 5, 6, 0], np.int32)
    kp, vp = _pool(rng, pool_dtype)
    q = rng.standard_normal((C, T, H, D)).astype(np.float32)
    pt = np.full((C, pps), N - 1, np.int32)
    for c in range(C):
        used = -(-(offset[c] + length[c]) // PAGE)
        pt[c, :used] = rng.permutation(N - 1)[:used]
    jk, tk = _both(kp, pool_dtype)
    jv, tv = _both(vp, pool_dtype)
    ref = np.asarray(jops.paged_prefill_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(offset),
        jnp.asarray(length), window=window, impl=impl))
    out = ops.paged_prefill_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(offset), torch.from_numpy(length), window=window)
    assert out.shape == (C, T, H, D)
    for c, n in enumerate(length):
        np.testing.assert_allclose(out[c, :n].numpy(), ref[c, :n],
                                   atol=2e-6, rtol=2e-6)


def test_auto_picks_plain_version_on_cpu_and_cuda_refuses_cpu():
    """``auto`` runs the plain version only because the tensors lie on
    the CPU; asking for the kernel with CPU tensors raises instead of
    falling back."""
    q = torch.zeros(1, H, D)
    pool = torch.zeros(N, PAGE, HKV, D)
    pt = torch.full((1, 2), N - 1, dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    assert ops.resolve_impl("auto", q) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(q, pool, pool, pt, lengths, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_prefill_attention(q[None], pool, pool, pt, lengths,
                                    lengths, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.resolve_impl("xla", q)


@pytest.mark.parametrize("pool_dtype,scales,match", [
    (torch.float32, "both", "neither"),
    (torch.bfloat16, "k", "neither"),
    (torch.int8, None, "both"),
    (torch.float8_e4m3fn, "k", "both"),
    (torch.int8, "wrong shape", "shape"),
    (torch.float8_e4m3fn, "wrong dtype", "float32"),
])
def test_scales_must_match_the_pool(pool_dtype, scales, match):
    """An int8 / fp8 pool takes both (N, Hkv) f32 scale tensors, any other
    pool neither; both implementations refuse anything else."""
    q = torch.zeros(1, H, D)
    pool = torch.zeros(N, PAGE, HKV, D).to(pool_dtype)
    pt = torch.full((1, 2), N - 1, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    good = torch.ones(N, HKV)
    ks, vs = {None: (None, None), "both": (good, good), "k": (good, None),
              "wrong shape": (good[1:], good[1:]),
              "wrong dtype": (good.double(), good.double())}[scales]
    for impl in ("torch", "cuda"):
        with pytest.raises(ValueError, match=match):
            ops.paged_decode_attention(q, pool, pool, pt, one, impl=impl,
                                       k_scales=ks, v_scales=vs)
        with pytest.raises(ValueError, match=match):
            ops.paged_prefill_attention(q[None], pool, pool, pt, one, one,
                                        impl=impl, k_scales=ks, v_scales=vs)
        with pytest.raises(ValueError, match=match):
            ops.paged_verify_attention(q[:, None], pool, pool, pt, one[None],
                                       impl=impl, k_scales=ks, v_scales=vs)
