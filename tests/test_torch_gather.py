"""The port's indexed gathers and access patterns against the JAX package.

``repro_torch.kernels.ops.gather_rows`` and ``moe_gather.gather_blocks``
with ``impl="torch"`` (and ``"auto"`` on CPU tensors) run the plain
versions (``index_select``); each must give, bit for bit, what the JAX
package's ``ops.gather_rows(impl="xla")`` and the Pallas kernels in
interpret mode give on the same numpy-seeded inputs at the reference's
shapes (``tests/test_kernels.py:164-183``), in f32 and in bf16 — a
gather moves bits, and bitwise is the reference's own bar.  Also here:
the ValueErrors where the reference asserts, dispatch, the kernels'
tuple, and the ported ``core.patterns`` against ``repro.core.patterns``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as jpat
from repro.kernels import moe_gather as jgather
from repro.kernels import ops as jops
from repro_torch import core as tcore
from repro_torch import kernels
from repro_torch.core import patterns as tpat
from repro_torch.kernels import moe_gather, ops, ref

ROW_SHAPES = [(64, 128, 32, 8), (128, 256, 64, 16), (32, 128, 8, 8)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _src(seed, N, d, dtype):
    """The same source on both sides: an f32 normal draw, rounded to
    bf16 alike (round to nearest even) where asked."""
    x = np.random.default_rng(seed).standard_normal((N, d)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _bits_equal(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout, np.float32),
                                  tout.float().numpy())


@pytest.mark.parametrize("jimpl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,d,M,rpb", ROW_SHAPES)
def test_gather_rows_bitwise_jax(N, d, M, rpb, dtype, jimpl):
    jsrc, tsrc = _src(N + M, N, d, dtype)
    idx = np.random.default_rng(M).integers(0, N, M).astype(np.int32)
    jout = jops.gather_rows(jsrc, jnp.asarray(idx), impl=jimpl,
                            rows_per_block=rpb)
    tidx = torch.from_numpy(idx)
    tout = ops.gather_rows(tsrc, tidx, rows_per_block=rpb)
    assert tout.shape == (M, d) and tout.dtype == tsrc.dtype
    _bits_equal(jout, tout)
    assert torch.equal(tout, ops.gather_rows(tsrc, tidx, impl="torch",
                                             rows_per_block=rpb))
    assert torch.equal(tout, kernels.gather_rows(tsrc, tidx))
    assert torch.equal(tout, ref.gather_rows_ref(tsrc, tidx))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,d,Mb,rows", [(64, 128, 6, 8), (48, 64, 5, 16),
                                         (32, 128, 1, 32)])
def test_gather_blocks_bitwise_jax(N, d, Mb, rows, dtype):
    jsrc, tsrc = _src(N + Mb, N, d, dtype)
    bidx = np.random.default_rng(Mb).integers(0, N // rows, Mb)
    bidx = bidx.astype(np.int32)
    jout = jgather.gather_blocks(jsrc, jnp.asarray(bidx), block_rows=rows,
                                 interpret=True)
    tout = moe_gather.gather_blocks(tsrc, torch.from_numpy(bidx),
                                    block_rows=rows)
    assert tout.shape == (Mb * rows, d) and tout.dtype == tsrc.dtype
    _bits_equal(jout, tout)
    expected = np.concatenate([np.asarray(jsrc, np.float32)[b * rows:
                                                           (b + 1) * rows]
                               for b in bidx])
    np.testing.assert_array_equal(expected, tout.float().numpy())


def test_gathers_refuse_what_the_reference_asserts():
    src = torch.zeros(64, 16)
    with pytest.raises(ValueError, match="rows_per_block"):
        ops.gather_rows(src, torch.zeros(12, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows_per_block"):
        ops.gather_rows(src, torch.zeros(8, dtype=torch.int32),
                        rows_per_block=0)
    with pytest.raises(ValueError, match="block_rows"):
        moe_gather.gather_blocks(torch.zeros(60, 16),
                                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.gather_rows(src, torch.zeros(8, dtype=torch.int32),
                        impl="interpret")


def test_cuda_impl_on_cpu_tensors_raises():
    src, idx = torch.zeros(64, 16), torch.zeros(8, dtype=torch.int32)
    for call in (lambda: ops.gather_rows(src, idx, impl="cuda"),
                 lambda: moe_gather.gather_blocks(src, idx, impl="cuda")):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()


def test_gather_kernels_tuple():
    names = [k.name for k in ops.GATHER_KERNELS]
    assert names == [f"gather_{kind}_{t}" for kind in ("rows", "blocks")
                     for t in ("f32", "bf16")]
    assert {k.source.name for k in ops.GATHER_KERNELS} == {"moe_gather.cu"}
    others = {k.name for k in (*ops.KERNELS, *ops.DENSE_KERNELS,
                               *ops.SSM_KERNELS)}
    assert not set(names) & others
    assert all(k.launches == 0 for k in ops.GATHER_KERNELS)


#: (what, call on the pattern module) — each evaluated on both packages
PATTERN_CASES = {
    "stream": lambda m: list(m.StreamPattern(total_bytes=1000)
                             .granule_ranges(256)),
    "stride": lambda m: list(m.StridePattern(
        total_bytes=0, block_bytes=300, stride_bytes=512, count=3)
        .granule_ranges(128)),
    "stride_contiguous": lambda m: m.granules(m.StridePattern(
        total_bytes=0, block_bytes=64, stride_bytes=64, count=4), 64),
    "stride_refused": lambda m: m.StridePattern(
        total_bytes=0, block_bytes=600, stride_bytes=512, count=1),
    "gather_runs": lambda m: list(m.GatherPattern(
        total_bytes=0, indices=(3, 4, 5, 9, 10, 2, 3, 4, 5, 6),
        elem_bytes=4).granule_ranges(12)),
    "gather_empty": lambda m: list(m.GatherPattern(total_bytes=0)
                                   .granule_ranges(64)),
    "scatter": lambda m: list(m.ScatterPattern(
        total_bytes=0, indices=(7, 8, 1, 2, 3), elem_bytes=8)
        .granule_ranges(64)),
    "granules_gather": lambda m: m.granules(m.GatherPattern(
        total_bytes=0, indices=tuple(range(100)), elem_bytes=2), 16),
    "coalescing_sorted": lambda m: m.coalescing_ratio(range(64), 4, 64),
    "coalescing_random": lambda m: m.coalescing_ratio(
        np.random.default_rng(0).integers(0, 50, 40), 2, 32),
    "coalescing_empty": lambda m: m.coalescing_ratio([], 4, 64),
    "base_abstract": lambda m: list(m.AccessPattern(total_bytes=8)
                                    .granule_ranges(4)),
}


@pytest.mark.parametrize("case", sorted(PATTERN_CASES))
def test_patterns_match_jax_package(case):
    fn = PATTERN_CASES[case]
    try:
        want = ("ok", fn(jpat))
    except (ValueError, NotImplementedError) as e:
        want = ("raised", type(e))
    try:
        got = ("ok", fn(tpat))
    except (ValueError, NotImplementedError) as e:
        got = ("raised", type(e))
    assert got == want
    if case == "stride_refused":
        assert got == ("raised", ValueError)


def test_core_exports_the_patterns():
    for name in ("AccessPattern", "StreamPattern", "StridePattern",
                 "GatherPattern", "ScatterPattern", "granules",
                 "coalescing_ratio"):
        assert getattr(tcore, name) is getattr(tpat, name)
        assert name in tcore.__all__
