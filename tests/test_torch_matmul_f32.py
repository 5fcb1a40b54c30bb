"""The f32 AMU matmul for Hopper (``csrc/amu_matmul.cu``).

On the CPU: the kernel's tile rule (``amu_matmul.f32_tiles``) — a tile of
its set, a ring that fits the 232,448 bytes a block may opt in to on an
H100, the grid of 1024^2 and of the quickstart's 256^2 output filling
the card, M = 8 taken, the choice that leaves the busiest SM the fewest
outputs — and the
reference's tiles still validated (``launch_tiles`` refuses ``bm=4``).

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_matmul_f32.py``):
every tile of the set, through the C entry point, gives outputs bitwise
equal to the others' at 1024^3, at the quickstart's shape and at ragged
M, N and K, within the reference's bar (5e-6 of
max |ref|) of the plain version; ``ops.matmul`` launches the kernel once
and gives the same bits.  Each output element sums its K products in
order, one fmaf each, so the tile changes no bit.
"""

import pytest
import torch

from repro_torch.kernels import amu_matmul, ops
from repro_torch.kernels.amu_matmul import (F32_STAGES, F32_TILES,
                                            f32_smem_bytes, f32_tiles,
                                            launch_tiles)

H100_SMEM = 232448      # shared memory a block may opt in to on an H100
H100_SMS = 132
#: 1024^3, the quickstart's product, and ragged M, N (8, 100, 264) and K
SHAPES = [(1024, 1024, 1024), (256, 512, 256), (8, 256, 100),
          (100, 200, 264), (264, 136, 8)]


def _blocks(M, N, bm, bn):
    return -(-M // bm) * -(-N // bn)


@pytest.mark.parametrize("M,N", [(1024, 1024), (256, 256), (8, 64),
                                 (8, 1024), (100, 264), (512, 8192),
                                 (4096, 4096), (1, 4)])
def test_tile_is_of_the_set_and_its_ring_fits(M, N):
    bm, bn, stages = f32_tiles(M, N, H100_SMS, H100_SMEM)
    assert (bm, bn) in F32_TILES
    assert stages == F32_STAGES
    assert f32_smem_bytes(bm, bn, stages) <= H100_SMEM


@pytest.mark.parametrize("M,N,least", [(1024, 1024, 120), (256, 256, 16)])
def test_grid_fills_the_card(M, N, least):
    """1024^2 lands near one full wave (256 blocks of 64 x 64, at most two
    an SM); the quickstart's 256^2 output gets many more blocks than its
    reference tiles' 4.  2048^2 and up take 128 x 128, the fastest there
    (``tools/f32_tile_sweep.py`` on an H100)."""
    bm, bn, _ = f32_tiles(M, N, H100_SMS, H100_SMEM)
    assert least <= _blocks(M, N, bm, bn)
    if (M, N) == (1024, 1024):
        assert (bm, bn) == (64, 64)
        assert _blocks(M, N, bm, bn) <= 2 * H100_SMS
    assert f32_tiles(2 * M, 2 * N, H100_SMS, H100_SMEM)[:2] \
        == ((128, 128) if M == 1024 else (64, 64))


@pytest.mark.parametrize("M,N", [(1024, 1024), (256, 256), (8, 64),
                                 (100, 264), (512, 8192), (200, 72)])
def test_tile_rule_takes_the_least_time(M, N):
    """No tile of the set leaves the busiest SM fewer outputs (its share
    of the blocks times a block's); of two that tie, the larger."""
    bm, bn, _ = f32_tiles(M, N, H100_SMS, H100_SMEM)

    def cost(tile):
        return -(-_blocks(M, N, *tile) // H100_SMS) * tile[0] * tile[1]

    best = min(cost(t) for t in F32_TILES)
    assert cost((bm, bn)) == best
    assert bm * bn == max(m * n for m, n in F32_TILES
                          if cost((m, n)) == best)


def test_reference_tiles_are_still_checked():
    """The reference's tiles are validated as before the card's tile
    replaced them: ``bm=4`` has no sub-tile a block can hold; a card
    whose shared memory does not hold the ring is refused."""
    with pytest.raises(ValueError, match="cannot hold"):
        launch_tiles(4, 128, 256, 4, H100_SMEM)
    with pytest.raises(ValueError, match="do not fit"):
        f32_tiles(1024, 1024, H100_SMS, 20000)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = before


def _direct(x, w, bm, bn, stages=F32_STAGES):
    """The C entry point with a given tile."""
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty(M, N, device=x.device)
    amu_matmul.KERNELS[torch.float32].launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, bm, bn, stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_every_tile_gives_the_same_bits(dev, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K * 3 + N)
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev)
    ref = ops.matmul(x, w, impl="torch")
    outs = {tile: _direct(x, w, *tile) for tile in F32_TILES}
    torch.cuda.synchronize()
    first = next(iter(outs.values()))
    rel = float((first - ref).abs().max() / ref.abs().max())
    assert rel < 5e-6, rel
    for tile, out in outs.items():
        assert torch.equal(out, first), tile


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1024, 1024, 1024), (256, 512, 256),
                                   (8, 128, 64)])
def test_ops_matmul_runs_the_card_tile_once(dev, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev)
    kernel = amu_matmul.KERNELS[torch.float32]
    before = kernel.launches
    out = ops.matmul(x, w)
    assert kernel.launches == before + 1
    props = torch.cuda.get_device_properties(dev)
    tile = f32_tiles(M, N, props.multi_processor_count,
                     props.shared_memory_per_block_optin)
    assert torch.equal(out, _direct(x, w, *tile))
    assert torch.equal(out, ops.matmul(x, w))


@pytest.mark.cuda
def test_entry_point_refuses_what_it_does_not_take(dev):
    x, w = torch.zeros(8, 8, device=dev), torch.zeros(8, 6, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _direct(x, w, 64, 64, 4)              # N not a multiple of 4
    with pytest.raises(RuntimeError, match="CUDA error"):
        _direct(x, torch.zeros(8, 8, device=dev), 48, 32, 4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _direct(x, torch.zeros(8, 8, device=dev), 64, 64, 3)
