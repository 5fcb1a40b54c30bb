"""The port's linear-recurrence entry points against the JAX package.

``repro_torch.kernels.ops.wkv6`` and ``ssd`` with ``impl="torch"`` (and
``"auto"`` on CPU tensors) run the port's chunked forms
(``repro_torch.models.ssm``); each must compute what the JAX package's
``ops.wkv6``/``ops.ssd`` compute on their XLA path and, through the
Pallas kernels, in interpret mode, on the same numpy-seeded inputs at
the reference's shapes (``tests/test_kernels.py:117-158``) and bars:
relative error (max |err| / max |ref|) under 1e-5 against the chunked
forms and the kernels, under 1e-4 against the sequential oracles
(chunked and sequential sum in different orders).  Also here: the
sequential forms, ``initial_state``/``return_state``, the factorized
mode, bf16 operands, a T that the chunk does not divide, and dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm

F32_CHUNKED, F32_SEQ = 1e-5, 1e-4


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


def _np(t):
    return t.float().numpy()


def _wkv6_inputs(seed, B, T, H, K, V=None):
    """(r, k, v, w, u) as numpy f32, drawn as the reference's test
    draws them: w = -exp(N(0,1) - 2), u = 0.1 N(0,1)."""
    rng = np.random.default_rng(seed)
    V = V or K
    r, k = (rng.standard_normal((B, T, H, K)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32)
    w = -np.exp(rng.standard_normal((B, T, H, K)) - 2).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _ssd_inputs(seed, B, T, H, P, N):
    """(x, dt, A, Bm, Cm, D) as numpy f32: dt = softplus(N(0,1)),
    A = linspace(0.5, 4, H), as the reference's test draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = np.linspace(0.5, 4.0, H).astype(np.float32)
    D = rng.standard_normal((H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    return x, dt, A, Bm, Cm, D


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,T,H,K,chunk", [
    (2, 128, 2, 32, 32),
    (1, 96, 4, 64, 32),
    (2, 64, 2, 128, 16),
    (1, 256, 1, 64, 64),
])
def test_wkv6_plain_matches_jax(B, T, H, K, chunk):
    arrays = _wkv6_inputs(T + K + chunk, B, T, H, K)
    ja, ta = _jax(arrays), _torch(arrays)
    out = ops.wkv6(*ta, impl="torch", chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (B, T, H, K)
    assert torch.equal(out, ops.wkv6(*ta, chunk=chunk))   # auto on CPU
    out = _np(out)
    for impl in ("xla", "interpret"):
        expected = jops.wkv6(*ja, impl=impl, chunk=chunk)
        assert _rel_err(out, expected) < F32_CHUNKED, impl
    assert _rel_err(out, jref.wkv6_ref(*ja)) < F32_SEQ
    assert _rel_err(out, _np(ref.wkv6_ref(*ta))) < F32_SEQ


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (2, 128, 2, 32, 16, 32),
    (1, 96, 4, 64, 32, 48),
    (1, 256, 2, 64, 64, 64),
])
def test_ssd_plain_matches_jax(B, T, H, P, N, chunk):
    arrays = _ssd_inputs(T + P + N, B, T, H, P, N)
    ja, ta = _jax(arrays), _torch(arrays)
    out = ops.ssd(*ta, impl="torch", chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (B, T, H, P)
    assert torch.equal(out, ops.ssd(*ta, chunk=chunk))    # auto on CPU
    out = _np(out)
    for impl in ("xla", "interpret"):
        expected = jops.ssd(*ja, impl=impl, chunk=chunk)
        assert _rel_err(out, expected) < F32_CHUNKED, impl
    assert _rel_err(out, jref.ssd_ref(*ja)) < F32_SEQ
    assert _rel_err(out, _np(ref.ssd_ref(*ta))) < F32_SEQ


def test_sequential_forms_match_jax():
    """The oracles themselves: the port's sequential forms against the
    reference's, outputs and (for SSD) the final state, at the chunked
    bar (both sum in the same order, up to einsum blocking)."""
    ja, ta = _jax(_wkv6_inputs(1, 2, 48, 2, 16)), \
        _torch(_wkv6_inputs(1, 2, 48, 2, 16))
    assert _rel_err(_np(ssm.wkv6_sequential(*ta)),
                    jssm.wkv6_sequential(*ja)) < F32_CHUNKED
    arrays = _ssd_inputs(2, 2, 48, 2, 16, 8)
    ja, ta = _jax(arrays), _torch(arrays)
    y, S = ssm.ssd_sequential(*ta)
    jy, jS = jssm.ssd_sequential(*ja)
    assert S.shape == (2, 2, 8, 16)
    assert _rel_err(_np(y), jy) < F32_CHUNKED
    assert _rel_err(_np(S), jS) < F32_CHUNKED


@pytest.mark.parametrize("T,chunk", [(64, 16), (100, 32)])
def test_state_in_and_out_match_jax(T, chunk):
    """``initial_state`` and ``return_state`` of both chunked forms, with
    a T that the chunk divides and one it does not (zero padding): the
    output and the final state against the reference's, and the state
    carried across a split of the sequence equal to the unsplit run."""
    rng = np.random.default_rng(T)
    B, H, K, P, N = 2, 2, 16, 16, 8
    arrays = _wkv6_inputs(T, B, T, H, K)
    S0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    (o, S), (jo, jS) = (
        ssm.wkv6_chunked(*_torch(arrays), chunk=chunk,
                         initial_state=torch.from_numpy(S0),
                         return_state=True),
        jssm.wkv6_chunked(*_jax(arrays), chunk=chunk,
                          initial_state=jnp.asarray(S0), return_state=True))
    assert o.shape == (B, T, H, K) and S.shape == (B, H, K, K)
    assert _rel_err(_np(o), jo) < F32_CHUNKED
    assert _rel_err(_np(S), jS) < F32_CHUNKED

    arrays = _ssd_inputs(T, B, T, H, P, N)
    S0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    (y, S), (jy, jS) = (
        ssm.ssd_chunked(*_torch(arrays), chunk=chunk,
                        initial_state=torch.from_numpy(S0),
                        return_state=True),
        jssm.ssd_chunked(*_jax(arrays), chunk=chunk,
                         initial_state=jnp.asarray(S0), return_state=True))
    assert y.shape == (B, T, H, P) and S.shape == (B, H, N, P)
    assert _rel_err(_np(y), jy) < F32_CHUNKED
    assert _rel_err(_np(S), jS) < F32_CHUNKED

    # the carried state: two halves through initial_state = one run
    ta = _torch(arrays)
    cut = T // 2
    y1, S1 = ssm.ssd_chunked(*(a[:, :cut] for a in ta[:2]), ta[2],
                             *(a[:, :cut] for a in ta[3:5]), ta[5],
                             chunk=chunk, return_state=True)
    y2, S2 = ssm.ssd_chunked(*(a[:, cut:] for a in ta[:2]), ta[2],
                             *(a[:, cut:] for a in ta[3:5]), ta[5],
                             chunk=chunk, initial_state=S1,
                             return_state=True)
    yw, Sw = ssm.ssd_chunked(*ta, chunk=chunk, return_state=True)
    assert _rel_err(_np(torch.cat([y1, y2], dim=1)), _np(yw)) < F32_SEQ
    assert _rel_err(_np(S2), _np(Sw)) < F32_SEQ


def test_wkv6_padded_chunk_matches_jax():
    """A T that the chunk does not divide: the entry point pads, as the
    reference's XLA path does, and agrees with it and the oracle."""
    arrays = _wkv6_inputs(7, 1, 100, 2, 32)
    ja, ta = _jax(arrays), _torch(arrays)
    out = _np(ops.wkv6(*ta, impl="torch", chunk=32))
    assert out.shape == (1, 100, 2, 32)
    assert _rel_err(out, jops.wkv6(*ja, impl="xla", chunk=32)) < F32_CHUNKED
    assert _rel_err(out, jref.wkv6_ref(*ja)) < F32_SEQ
    arrays = _ssd_inputs(8, 1, 100, 2, 32, 16)
    out = _np(ops.ssd(*_torch(arrays), impl="torch", chunk=32))
    assert _rel_err(out, jops.ssd(*_jax(arrays), impl="xla",
                                  chunk=32)) < F32_CHUNKED


def test_wkv6_factorized_and_bf16_operands_match_jax():
    """``mode="factorized"`` at the f32 chunked bar; bf16 matmul operands
    (``operand_dtype``, the model's native-dtype policy) at 2e-2, the
    reference's bf16 bar (``tests/test_kernels.py``): both sides round
    the same f32 values to bf16, but those values may differ in their
    last f32 bit, which can move a bf16 rounding by one step."""
    arrays = _wkv6_inputs(9, 2, 96, 2, 32)
    ja, ta = _jax(arrays), _torch(arrays)
    out = ssm.wkv6_chunked(*ta, chunk=32, mode="factorized")
    expected = jssm.wkv6_chunked(*ja, chunk=32, mode="factorized")
    assert _rel_err(_np(out), expected) < F32_CHUNKED
    # factorized drops contributions decayed below e^-20: near pairwise
    assert _rel_err(_np(out), jref.wkv6_ref(*ja)) < F32_SEQ
    out = ssm.wkv6_chunked(*ta, chunk=32, operand_dtype=torch.bfloat16)
    expected = jssm.wkv6_chunked(*ja, chunk=32,
                                 operand_dtype=jnp.bfloat16)
    assert out.dtype == torch.float32
    assert _rel_err(_np(out), expected) < 2e-2


def test_bf16_inputs_match_jax():
    """bf16 r/k/v (w and u f32, the model's mix) and bf16 x/B/C (dt, A,
    D f32): the plain versions against the reference's XLA path on the
    same bf16 values, both computing in f32, at the reference's bf16 bar
    (2e-2: the outputs round to bf16 after f32 sums in another order)."""
    r, k, v, w, u = _wkv6_inputs(10, 1, 128, 2, 64)
    ja = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)] + _jax((w, u))
    ta = [torch.from_numpy(a).bfloat16() for a in (r, k, v)] \
        + _torch((w, u))
    out = ops.wkv6(*ta, impl="torch")
    assert out.dtype == torch.bfloat16
    assert _rel_err(_np(out), jops.wkv6(*ja, impl="xla")) < 2e-2
    x, dt, A, Bm, Cm, D = _ssd_inputs(11, 1, 128, 2, 64, 64)
    ja = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16),
          jnp.asarray(D)]
    ta = [torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(Bm).bfloat16(),
          torch.from_numpy(Cm).bfloat16(), torch.from_numpy(D)]
    out = ops.ssd(*ta, impl="torch", chunk=64)
    assert out.dtype == torch.bfloat16
    assert _rel_err(_np(out), jops.ssd(*ja, impl="xla", chunk=64)) < 2e-2


def test_dispatch():
    r, k, v, w, u = _torch(_wkv6_inputs(12, 1, 64, 2, 16))
    x, dt, A, Bm, Cm, D = _torch(_ssd_inputs(13, 1, 64, 2, 16, 8))
    for call in (lambda: ops.wkv6(r, k, v, w, u, impl="cuda"),
                 lambda: ops.ssd(x, dt, A, Bm, Cm, D, impl="cuda")):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    # the kernels take no T that the chunk does not divide (the TPU
    # kernels assert it); the plain versions pad
    for call in (lambda: ops.wkv6(r, k, v, w, u, impl="cuda", chunk=48),
                 lambda: ops.ssd(x, dt, A, Bm, Cm, D, impl="cuda",
                                 chunk=48)):
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            call()
    assert ops.wkv6(r, k, v, w, u, chunk=48).shape == (1, 64, 2, 16)
    with pytest.raises(AssertionError):
        jops.wkv6(*_jax(_wkv6_inputs(12, 1, 64, 2, 16)), impl="interpret",
                  chunk=48)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.ssd(x, dt, A, Bm, Cm, D, impl="pallas")
    assert {k.name for k in ops.SSM_KERNELS} == {
        f"{n}_{t}" for n in ("wkv6", "ssd") for t in ("f32", "bf16")}
    assert not {k.name for k in ops.SSM_KERNELS} & {
        k.name for k in (*ops.KERNELS, *ops.DENSE_KERNELS)}
    # exported from the package, as the JAX package exports them
    assert kernels.wkv6 is ops.wkv6 and kernels.ssd is ops.ssd
    assert kernels.paged_decode_attention is ops.paged_decode_attention
