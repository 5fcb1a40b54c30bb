"""The dense decode kernel's split over positions (flash-decoding).

On the CPU: the properties of ``decode_attention.decode_splits`` and of
the ranges the kernel cuts (``split_ranges``): they cover
[0, valid_len) once, start on multiples of 64, none lies past valid_len
at the default count, one range up to 256 positions, at least two blocks
per SM for the phase-2d shapes of ``chip_smoke.py``; and an f32
emulation of the kernel's split-and-combine in plain torch — 64-position
tiles with the online softmax inside a range, the ranges merged in order
by the log-sum-exp rule of ``csrc/split_kv.cuh``, empty ranges with the
finite sentinel m = -1e30, l = 0 — held against the JAX ``decode_attention``
in interpret mode at the reference's f32 bar, 5e-6 of max |ref|.

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_split.py``):
the kernel against its plain version at phase 2's bars (f32: 5e-6 of
max |ref|; bf16: atol 4e-3 + rtol 1e-2 per element, 1e-2 relative L2
per row) with the split count forced to 1, to one tile per range and
past it (empty ranges), and left to ``decode_splits``, for valid_len 0,
1, 63, 64, 65, 2000 and 2048, every head dim and G in {1, 3, 5, 12,
16}; valid_len 0 stores zeros; two calls give the same bits, one launch
counted per call.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import HEAD_DIMS
from repro_torch.kernels.decode_attention import (DENSE_KERNELS, NEG_INF,
                                                  decode_attention_cuda,
                                                  decode_splits,
                                                  split_ranges)

H100_SMS = 132
#: (B, Hkv, G, valid_len) of chip_smoke.py's phase-2d dense decode cases
PHASE_2D = [(8, 8, 3, 2000), (2, 2, 4, 1000), (8, 8, 5, 2000),
            (8, 8, 12, 2000), (8, 8, 4, 2000)]
VALID = (0, 1, 63, 64, 65, 255, 256, 257, 1000, 2000, 2048, 4096, 10000)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B,Hkv,G", [(1, 1, 1), (2, 2, 4), (8, 8, 3),
                                     (1, 8, 16), (64, 8, 12), (4, 1, 40)])
@pytest.mark.parametrize("valid", VALID)
def test_default_ranges_cover_the_positions_once(B, Hkv, G, valid):
    splits = decode_splits(B, Hkv, G, valid, H100_SMS)
    assert splits >= 1
    assert splits == decode_splits(B, Hkv, G, valid, H100_SMS)
    ranges = split_ranges(valid, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == valid
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1                      # contiguous, no overlap
    for s, e in ranges:
        assert s % 64 == 0
        assert s < e or valid == 0           # no range past valid_len
    for s, e in ranges[:-1]:
        assert e - s >= 256 and (e - s) % 64 == 0
    if valid <= 256:
        assert splits == 1


@pytest.mark.parametrize("B,Hkv,G,valid", PHASE_2D)
def test_phase_2d_shapes_fill_the_card(B, Hkv, G, valid):
    """The bf16 cases (8 sequences, 8 KV heads) get at least two blocks
    per SM, 320 where the unsplit kernel had 64; the f32 case (2 x 2 KV
    heads, 1000 positions) as many ranges as 256 positions each allow."""
    splits = decode_splits(B, Hkv, G, valid, H100_SMS)
    if B * Hkv == 64:
        assert B * Hkv * splits >= 2 * H100_SMS, splits
    else:
        assert splits == valid // 256


@pytest.mark.parametrize("valid,splits", [(0, 1), (0, 3), (65, 5),
                                          (2000, 40), (128, 2)])
def test_forced_ranges_past_the_tiles_are_empty(valid, splits):
    ranges = split_ranges(valid, splits)
    tiles = -(-valid // 64)
    covered = [r for r in ranges if r[0] < r[1]]
    assert len(covered) == min(tiles, splits) or tiles == 0
    assert all(s == e == valid for s, e in ranges[len(covered):])
    assert sum(e - s for s, e in ranges) == valid


def split_combine(q, k, v, valid, splits):
    """f32 split-and-combine as the kernel computes it: q (B, H, D), k/v
    (B, Skv, Hkv, D) -> (B, H, D)."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Hkv, H // Hkv, D) * (1.0 / math.sqrt(D))
    kf, vf = k.float(), v.float()
    ms, ls, accs = [], [], []
    for s0, e0 in split_ranges(valid, splits):
        m = torch.full((B, Hkv, H // Hkv, 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, H // Hkv, D)
        for t0 in range(s0, e0, 64):
            t1 = min(t0 + 64, e0)
            s = torch.einsum("bhgd,bkhd->bhgk", qf, kf[:, t0:t1])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhgk,bkhd->bhgd", p,
                                            vf[:, t0:t1])
            m = m_new
        ms.append(m), ls.append(l), accs.append(acc)
    big = torch.stack(ms).amax(0)
    den, num = torch.zeros_like(big), torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.exp(m - big)             # 0 for an empty range
        den, num = den + l * w, num + acc * w
    return (num / den.clamp_min(1e-30)).reshape(B, H, D).to(q.dtype)


@pytest.mark.parametrize("valid", [0, 1, 65, 300, 512])
def test_split_combine_matches_jax(valid):
    """Every split count, empty ranges included, gives the JAX kernel's
    output at the reference's f32 bar; valid_len 0 gives zeros."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as jdecode

    B, H, Hkv, Skv, D = 2, 6, 2, 512, 64
    rng = np.random.default_rng(valid)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    ref = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             valid_len=valid, bkv=128, interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tiles = -(-valid // 64)
    for splits in sorted({1, 2, 3, decode_splits(B, Hkv, H // Hkv, valid,
                                                 H100_SMS),
                          max(1, tiles), tiles + 2}):
        out = split_combine(tq, tk, tv, valid, splits).numpy()
        assert np.isfinite(out).all()
        if valid == 0:
            assert not out.any() and not ref.any()
            continue
        rel = np.abs(out - ref).max() / np.abs(ref).max()
        assert rel < 5e-6, (splits, rel)


# ---- on the card ----

ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2
CARD_VALID = (0, 1, 63, 64, 65, 2000, 2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = before


def _agree(out, ref, what):
    assert out.dtype == ref.dtype and out.shape == ref.shape, what
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all(), what
    if out.dtype == torch.float32:
        rel = float((o - r).abs().max() / r.abs().max().clamp_min(1e-30))
        assert rel < 5e-6, (what, rel)
        return
    torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL, msg=str(what))
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert torch.all(row <= ROW_TOL), (what, float(row.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("groups", [1, 3, 5, 12, 16])
def test_kernel_matches_plain_at_every_split(dev, dtype, head_dim, groups):
    B, Hkv, Skv = 2, 2, 2048
    gen = torch.Generator(device=dev).manual_seed(head_dim * 31 + groups)
    q = torch.randn(B, Hkv * groups, head_dim, generator=gen,
                    device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, head_dim, generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, head_dim, generator=gen,
                    device=dev).to(dtype)
    kernel = DENSE_KERNELS[dtype]
    for valid in CARD_VALID:
        ref = ops.decode_attention(q, k, v, valid_len=valid, impl="torch")
        tiles = -(-valid // 64)
        for splits in (1, None, max(1, tiles), tiles + 3):
            before = kernel.launches
            out = decode_attention_cuda(q, k, v, valid, splits=splits)
            assert kernel.launches == before + 1
            what = (valid, splits)
            if valid == 0:
                assert not out.float().any(), what
            else:
                _agree(out, ref, what)
            again = decode_attention_cuda(q, k, v, valid, splits=splits)
            assert torch.equal(out, again), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_2d_case_through_ops(dev, dtype):
    """The bf16 case of phase 2d (8 sequences, 24/8 heads of 128, 2000 of
    2048) through ``ops.decode_attention``, split as ``decode_splits``
    says: one launch, the plain version's output, the same bits twice."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(8, 24, 128, generator=gen, device=dev).to(dtype)
    k = torch.randn(8, 2048, 8, 128, generator=gen, device=dev).to(dtype)
    v = torch.randn(8, 2048, 8, 128, generator=gen, device=dev).to(dtype)
    kernel = DENSE_KERNELS[dtype]
    before = kernel.launches
    out = ops.decode_attention(q, k, v, valid_len=2000, bkv=256)
    assert kernel.launches == before + 1
    _agree(out, ops.decode_attention(q, k, v, valid_len=2000, impl="torch"),
           "phase 2d")
    assert torch.equal(out, ops.decode_attention(q, k, v, valid_len=2000))
    assert torch.equal(out, decode_attention_cuda(
        q, k, v, 2000, splits=decode_splits(8, 8, 3, 2000, torch.cuda.
                                            get_device_properties(dev).
                                            multi_processor_count)))
