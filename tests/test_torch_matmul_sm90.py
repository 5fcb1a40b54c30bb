"""The bf16 AMU matmul for Hopper (``csrc/amu_matmul_sm90.cu``).

On the CPU: the kernel's tile, grid and ring-depth rule
(``amu_matmul.sm90_tiles``) — its shared-memory reckoning against the
232,448 bytes a block may opt in to on an H100, the grid of phi4-mini's
MLP products filling at least 120 of the 132 SMs, the least-time choice
over every tile the kernel has — its refusal of row strides TMA cannot
take, and the plain version in bf16 against the JAX kernel
(interpret mode) at the reference's bf16 bar, 2e-2 relative.

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_matmul_sm90.py``):
a selection matrix w must pick x's columns exactly (a wrong descriptor
bit gives plausible but wrong numbers), every bf16 shape of
``tests/test_torch_cuda.py``'s matmul test and ragged M, N and K
against the plain version at the bars of the paged kernels (atol 4e-3 +
rtol 1e-2 per element, 1e-2 relative L2 per row), phi4-mini's two MLP
products the same way, two calls bitwise equal, and one launch counted
per call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.amu_matmul import amu_matmul as jamu_matmul
from repro_torch.kernels import amu_matmul, ops
from repro_torch.kernels.amu_matmul import (SM90_BM, SM90_BN, SM90_MAX_STAGES,
                                            check_tma, sm90_smem_bytes,
                                            sm90_stages, sm90_tiles)

H100_SMEM = 232448      # shared memory a block may opt in to on an H100
H100_SMS = 132
#: phi4-mini-3.8b's MLP products over two 256-token chunks: gate/up, down
MLP = [(512, 3072, 8192), (512, 8192, 3072)]
ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2


def _blocks(M, N, bm, bn):
    return -(-M // bm) * -(-N // bn)


@pytest.mark.parametrize("bm", SM90_BM)
@pytest.mark.parametrize("bn", SM90_BN)
def test_ring_fits_the_shared_memory(bm, bn):
    """The ring is as deep as 232,448 bytes hold, at most 8 stages, and
    a stage is one 64-deep x tile and w tile in bf16 plus two barriers."""
    stages = sm90_stages(bm, bn, H100_SMEM)
    assert 2 <= stages <= SM90_MAX_STAGES
    assert sm90_smem_bytes(bm, bn, stages) <= H100_SMEM
    assert stages == SM90_MAX_STAGES \
        or sm90_smem_bytes(bm, bn, stages + 1) > H100_SMEM
    assert sm90_smem_bytes(bm, bn, 1) == 1024 + (bm + bn) * 64 * 2 + 16


@pytest.mark.parametrize("M,K,N", MLP)
def test_mlp_products_fill_the_card(M, K, N):
    """Both MLP products run in about one wave: at least 120 of the 132
    SMs, in 128 x 256 tiles (4 stages, 197,696 bytes) for gate/up and
    64 x 192 (7 stages, 230,512 bytes) for down."""
    bm, bn, stages = sm90_tiles(M, N, H100_SMS, H100_SMEM)
    assert 120 <= _blocks(M, N, bm, bn) <= H100_SMS
    assert sm90_smem_bytes(bm, bn, stages) <= H100_SMEM
    want = {8192: (128, 256, 4, 197696), 3072: (64, 192, 7, 230512)}[N]
    assert (bm, bn, stages, sm90_smem_bytes(bm, bn, stages)) == want


@pytest.mark.parametrize("M,N", [(512, 8192), (512, 3072), (8, 64),
                                 (384, 128), (128, 512), (256, 256),
                                 (1024, 1024), (200, 72), (4096, 4096),
                                 (1, 8)])
def test_tile_rule_takes_the_least_time(M, N):
    """The chosen tile is one the kernel has, and no other tile's grid
    takes fewer waves times a block's work; of two that tie it is the
    larger."""
    bm, bn, stages = sm90_tiles(M, N, H100_SMS, H100_SMEM)
    assert bm in SM90_BM and bn in SM90_BN
    assert stages == sm90_stages(bm, bn, H100_SMEM)

    def cost(tile):
        waves = -(-_blocks(M, N, *tile) // H100_SMS)
        return waves * tile[0] * tile[1]

    best = min(cost((m, n)) for m in SM90_BM for n in SM90_BN)
    assert cost((bm, bn)) == best
    assert bm * bn == max(m * n for m in SM90_BM for n in SM90_BN
                          if cost((m, n)) == best)


def test_tma_refuses_what_it_cannot_read():
    """Row strides must be multiples of 16 bytes (bf16 K and N multiples
    of 8); the shapes of the MLP and of the cuda tests pass; a ring of
    fewer than two stages is refused."""
    for K, N in ((3072, 8192), (8192, 3072), (128, 64), (136, 72), (8, 8)):
        check_tma(K, N)
    for K, N in ((12, 64), (64, 100), (4, 4)):
        with pytest.raises(ValueError, match="multiples of 8"):
            check_tma(K, N)
    with pytest.raises(ValueError, match="do not fit"):
        sm90_tiles(64, 64, H100_SMS, 30000)


@pytest.mark.parametrize("M,K,N,tiles", [
    (8, 128, 64, {}),                                  # planned tiles
    (200, 136, 72, dict(bm=200, bk=136, bn=72)),       # ragged for TMA
    (384, 768, 128, dict(bm=128, bk=256, bn=128)),
])
def test_bf16_plain_matches_jax(M, K, N, tiles):
    """The plain version the kernel is held to, in bf16, against the JAX
    kernel in interpret mode, at the reference's bf16 bar."""
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    out = ops.matmul(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(w).bfloat16(), **tiles)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    ref = np.asarray(jamu_matmul(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16), **tiles),
                     np.float32)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _assert_agree(out, ref):
    o, r = out.float(), ref.float()
    torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert torch.all(row <= ROW_TOL), row.max()


def _counted(x, w, **tiles):
    kernel = amu_matmul.KERNELS[torch.bfloat16]
    before = kernel.launches
    out = ops.matmul(x, w, **tiles)
    assert kernel.launches == before + 1
    return out


#: shapes that run every tile the MLP products and the small cases take,
#: with ragged M, N and K; the reference's tiles where its planner's do
#: not tile the shape
RAGGED = (200, 136, 72, dict(bm=200, bk=136, bn=72))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,tiles", [(128, 256, 256, {}),
                                         (64, 128, 64, {}), RAGGED,
                                         *[(*s, {}) for s in MLP]])
def test_selection_matrix_picks_columns_exactly(dev, M, K, N, tiles):
    """w[src[n], n] = 1: out[:, n] is x's column src[n], bit for bit,
    whatever the tile; a column that is not names what it matched."""
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
    src = torch.randperm(max(K, N), generator=gen, device=dev)[:N] % K
    w = torch.zeros(K, N, device=dev, dtype=torch.bfloat16)
    w[src, torch.arange(N, device=dev)] = 1
    out = _counted(x, w, **tiles)
    torch.cuda.synchronize()
    bad = (out != x[:, src]).any(dim=0).nonzero().flatten()
    if len(bad):
        n = int(bad[0])
        hit = (x == out[:, n:n + 1]).all(dim=0).nonzero().flatten().tolist()
        pytest.fail(f"{len(bad)} of {N} columns wrong; column {n} should "
                    f"be x[:, {int(src[n])}], matches x columns {hit[:8]}")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,tiles", [
    (256, 512, 256, dict(bm=128, bk=128, bn=128)),
    (384, 768, 128, dict(bm=128, bk=256, bn=128)),
    (128, 128, 128, dict(bm=128, bk=128, bn=128)),
    (128, 384, 512, {}),
    (8, 128, 64, {}),
    RAGGED,                                            # ragged M, N, K
    (1, 8, 8, {}),
    *[(*s, {}) for s in MLP],
])
def test_bf16_kernel_matches_plain(dev, M, K, N, tiles):
    gen = torch.Generator(device=dev).manual_seed(M * N + K)
    x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
    w = torch.randn(K, N, generator=gen, device=dev).bfloat16()
    out = _counted(x, w, **tiles)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    _assert_agree(out, ops.matmul(x, w, impl="torch"))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", MLP)
def test_two_calls_are_bitwise_equal(dev, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(K)
    x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
    w = torch.randn(K, N, generator=gen, device=dev).bfloat16()
    assert torch.equal(_counted(x, w), _counted(x, w))


@pytest.mark.cuda
def test_bf16_kernel_refuses_what_tma_cannot_read(dev):
    x = torch.zeros(64, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.matmul(x, torch.zeros(12, 64, device=dev, dtype=torch.bfloat16))
    buf = torch.zeros(64 * 64 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x is not 16-byte aligned"):
        ops.matmul(buf[1:].view(64, 64), torch.zeros(
            64, 64, device=dev, dtype=torch.bfloat16))
