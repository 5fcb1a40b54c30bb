"""The row gather's plan (``moe_gather.gather_plan``).

On the CPU: the plan's pieces cover every byte of every output row
exactly once; on the vec route every piece starts and ends on a 16-byte
boundary; rows whose bytes or base pointers are not 16-byte aligned
take the element route, a piece an element, other rows the vec route;
a block takes 256 threads, fewer (to 32) only so that every SM gets a
block.
Then the plan's copy emulated piece by piece in plain torch, bitwise
``index_select`` and the JAX package's ``gather_rows`` (the xla path
and the Pallas kernel in interpret mode) at the reference's shapes and
olmoe-1b-7b's.

The block gather is the row gather over the view (N / block_rows,
block_rows * d): its plan's pieces cover every byte of every block once
(the paged-KV fetch's 32,768-byte blocks, the reference's 4,096-byte f32
blocks, an odd 30-byte block), and its emulated copy is bitwise
``gather_blocks_torch`` and the JAX package's ``gather_blocks`` (the
Pallas kernel in interpret mode).

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_gather_plan.py``):
the kernel is bitwise ``index_select`` in f32 and bf16, for unaligned
rows and pointers too; one launch counted per call; ``gather_blocks``
unchanged, and on unaligned blocks (the element route) bitwise its
plain version, one launch a call.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gather, ops
from repro_torch.kernels.moe_gather import (MAX_THREADS, MIN_THREADS,
                                            gather_plan)

H100_SMS = 132
#: (M, row bytes): the reference's f32 shapes, olmoe's dispatch and
#: combine rows (bf16, d 2048), and odd ones
SHAPES = [(32, 512), (64, 1024), (8, 512), (512, 4096), (5120, 4096),
          (4096, 4096), (64, 4096), (3, 8192 + 16), (7, 6), (100, 2050),
          (1, 16), (1000, 48), (2048, 4096 + 48)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row_pieces(plan, row_bytes):
    """(start, bytes) of the pieces of one row, in order."""
    starts = np.arange(plan.per_row, dtype=np.int64) * plan.piece_bytes
    return starts, np.minimum(plan.piece_bytes, row_bytes - starts)


ELEM_BYTES = (2, 4)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("M,row_bytes,elem_bytes", [
    (M, r, e) for M, r in SHAPES for e in ELEM_BYTES if r % e == 0])
def test_pieces_cover_every_byte_once(M, row_bytes, aligned, elem_bytes):
    plan = gather_plan(M, row_bytes, H100_SMS, elem_bytes=elem_bytes,
                       aligned=aligned)
    starts, sizes = row_pieces(plan, row_bytes)
    # a row's pieces tile its bytes: each starts where the last ended
    assert starts[0] == 0 and (sizes > 0).all()
    assert (starts[1:] == starts[:-1] + sizes[:-1]).all()
    assert starts[-1] + sizes[-1] == row_bytes
    assert (sizes <= plan.piece_bytes).all()
    if plan.route == "elem":
        assert (starts % elem_bytes == 0).all() and (sizes == elem_bytes).all()
    else:
        assert (starts % 16 == 0).all() and (sizes % 16 == 0).all()
    # every row its pieces, every piece a thread of one block
    assert plan.pieces == M * plan.per_row
    assert (plan.blocks - 1) * plan.threads < plan.pieces \
        <= plan.blocks * plan.threads


@pytest.mark.parametrize("M,row_bytes", SHAPES)
def test_routes_and_blocks(M, row_bytes):
    plan = gather_plan(M, row_bytes, H100_SMS)
    assert plan.route == ("elem" if row_bytes % 16 else "vec")
    assert plan.piece_bytes == {"elem": 2, "vec": 16}[plan.route]
    assert gather_plan(M, row_bytes, H100_SMS, aligned=False).route == "elem"
    # a block: the most threads that fill the SMs
    assert MIN_THREADS <= plan.threads <= MAX_THREADS
    assert plan.threads == MIN_THREADS or plan.blocks >= H100_SMS
    assert plan.threads == MAX_THREADS \
        or -(-plan.pieces // (2 * plan.threads)) < H100_SMS


def test_olmoe_rows():
    """olmoe's 4 KB rows (bf16, d 2048): the decode dispatch (512 rows),
    the decode combine (64) and the prefill dispatch (5120) and combine
    (4096) take the vec route over the card, 256 threads a row."""
    assert gather_plan(512, 4096, H100_SMS) == moe_gather.GatherPlan(
        "vec", 16, 256, 131072, 256, 512)
    assert gather_plan(64, 4096, H100_SMS) == moe_gather.GatherPlan(
        "vec", 16, 256, 16384, 64, 256)
    for M in (5120, 4096):
        assert gather_plan(M, 4096, H100_SMS) == moe_gather.GatherPlan(
            "vec", 16, 256, 256 * M, 256, M)


def emulate(src, idx, aligned=True):
    """The kernel's copy on the bytes of src (N, d): piece p of every
    row from piece p of its source row."""
    M, (N, d) = idx.shape[0], src.shape
    row_bytes = d * src.element_size()
    sb = src.contiguous().view(torch.uint8).reshape(N, row_bytes)
    out = torch.full((M, row_bytes), 0xAB, dtype=torch.uint8)
    plan = gather_plan(M, row_bytes, H100_SMS,
                       elem_bytes=src.element_size(), aligned=aligned)
    rows = idx.long()                     # each row's index, loaded once
    for start, n in zip(*row_pieces(plan, row_bytes)):
        out[:, start:start + n] = sb[rows, start:start + n]
    return out.view(src.dtype).reshape(M, d)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,M", [(64, 128, 32), (128, 256, 64),
                                   (32, 128, 8), (9, 2048, 512),
                                   (50, 2048, 64), (40, 3, 24),
                                   (100, 2048, 2048)])
def test_emulated_plan_is_bitwise_the_gather(N, d, M, dtype, aligned):
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    rng = np.random.default_rng(N + d + M)
    x = rng.standard_normal((N, d)).astype(np.float32)
    idx = rng.integers(0, N, M).astype(np.int32)
    src, tidx = torch.from_numpy(x).to(dtype), torch.from_numpy(idx)
    out = emulate(src, tidx, aligned)
    assert torch.equal(out, torch.index_select(src, 0, tidx.long()))
    assert torch.equal(out, ops.gather_rows(src, tidx, rows_per_block=1))
    jsrc = jnp.asarray(x, jnp.float32 if dtype == torch.float32
                       else jnp.bfloat16)
    for jimpl in ("xla", "interpret"):
        jout = jops.gather_rows(jsrc, jnp.asarray(idx), impl=jimpl,
                                rows_per_block=8 if M % 8 == 0 else 1)
        np.testing.assert_array_equal(np.asarray(jout, np.float32),
                                      out.float().numpy())


#: (N, d, Mb, block_rows, dtype): the paged-KV fetch (128 of 448 frames
#: of 16 rows of 8 x 128 bf16: 32,768-byte blocks), the reference's
#: (64, 128) f32 in blocks of 8 rows (4,096 bytes), and an odd block
#: byte count (3 rows of 5 bf16: 30 bytes, the element route)
BLOCK_SHAPES = [(448 * 16, 1024, 128, 16, torch.bfloat16),
                (64, 128, 6, 8, torch.float32),
                (48, 5, 20, 3, torch.bfloat16)]


@pytest.mark.parametrize("N,d,Mb,rows,dtype", BLOCK_SHAPES)
def test_block_plan_is_the_row_plan_over_blocks(N, d, Mb, rows, dtype):
    import jax.numpy as jnp
    from repro.kernels import moe_gather as jgather

    el = torch.tensor([], dtype=dtype).element_size()
    block_bytes = rows * d * el
    plan = gather_plan(Mb, block_bytes, H100_SMS, elem_bytes=el)
    assert plan.route == ("vec" if block_bytes % 16 == 0 else "elem")
    starts, sizes = row_pieces(plan, block_bytes)
    assert starts[0] == 0 and (sizes > 0).all()
    assert (starts[1:] == starts[:-1] + sizes[:-1]).all()
    assert starts[-1] + sizes[-1] == block_bytes
    assert plan.pieces == Mb * plan.per_row
    assert (plan.blocks - 1) * plan.threads < plan.pieces \
        <= plan.blocks * plan.threads
    if block_bytes == 32768:              # the paged-KV fetch
        assert plan == moe_gather.GatherPlan("vec", 16, 2048, 262144, 256,
                                             1024)
    rng = np.random.default_rng(N + Mb)
    x = rng.standard_normal((N, d)).astype(np.float32)
    bidx = rng.permutation(N // rows)[:Mb].astype(np.int32)
    src, tidx = torch.from_numpy(x).to(dtype), torch.from_numpy(bidx)
    out = emulate(src.view(N // rows, rows * d), tidx).reshape(-1, d)
    assert torch.equal(out, moe_gather.gather_blocks_torch(src, tidx, rows))
    assert torch.equal(out, moe_gather.gather_blocks(src, tidx,
                                                     block_rows=rows))
    jsrc = jnp.asarray(x, jnp.float32 if dtype == torch.float32
                       else jnp.bfloat16)
    jout = jgather.gather_blocks(jsrc, jnp.asarray(bidx), block_rows=rows,
                                 interpret=True)
    np.testing.assert_array_equal(np.asarray(jout, np.float32),
                                  out.float().numpy())


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,M", [(64, 128, 32), (128, 256, 64),
                                   (32, 128, 8), (9, 2048, 512),
                                   (2049, 2048, 4096), (50, 2048, 64),
                                   (300, 4104, 40), (40, 3, 24),
                                   (1000, 8, 1000)])
def test_kernel_bitwise_index_select(dev, N, d, M, dtype):
    gen = torch.Generator(device=dev).manual_seed(N + d + M)
    src = torch.randn(N, d, generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, N, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    expected = torch.index_select(src, 0, idx)
    kernel = moe_gather.KERNELS[dtype]
    before = kernel.launches
    out = ops.gather_rows(src, idx, rows_per_block=1)
    assert kernel.launches == before + 1
    assert torch.equal(out, expected)
    # a base pointer off the 16-byte grid: the element route
    flat = torch.randn(N * d + 1, generator=gen, device=dev).to(dtype)
    shifted = flat[1:].view(N, d)
    assert torch.equal(ops.gather_rows(shifted, idx, rows_per_block=1),
                       torch.index_select(shifted, 0, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_blocks_unchanged(dev, dtype):
    src = torch.randn(448 * 16, 1024, device=dev).to(dtype)
    bidx = torch.randperm(448, device=dev)[:128].to(torch.int32)
    out = moe_gather.gather_blocks(src, bidx, block_rows=16)
    assert torch.equal(out, moe_gather.gather_blocks_torch(src, bidx, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_blocks_take_the_element_route(dev, dtype):
    """Blocks whose bytes (3 rows of 5) or base pointer are off the
    16-byte grid: the element route, bitwise the plain version, one
    launch a call."""
    kernel = moe_gather.BLOCK_KERNELS[dtype]
    gen = torch.Generator(device=dev).manual_seed(5)
    bidx = torch.randperm(16, generator=gen, device=dev)[:10].to(torch.int32)
    flat = torch.randn(48 * 8 + 1, generator=gen, device=dev).to(dtype)
    el = flat.element_size()
    for src, rows in ((flat[:48 * 5].view(48, 5), 3),
                      (flat[1:].view(48, 8), 3)):
        aligned = src.data_ptr() % 16 == 0
        assert gather_plan(10, rows * src.shape[1] * el, H100_SMS,
                           elem_bytes=el, aligned=aligned).route == "elem"
        before = kernel.launches
        out = moe_gather.gather_blocks(src, bidx, block_rows=rows)
        assert kernel.launches == before + 1
        assert torch.equal(out,
                           moe_gather.gather_blocks_torch(src, bidx, rows))
