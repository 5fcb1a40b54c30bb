"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
no CUDA device is present, as on a CPU-only machine).

Run on a machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same bf16
inputs, over ragged lengths, page edges and GQA group sizes: every
element within atol 4e-3 + rtol 1e-2 (one bf16 step at any magnitude),
every output row of D values within a relative L2 error of 1e-2 (a
skipped or repeated page exceeds it).  The int8 / fp8 instances of the
quantized pool are held to their plain versions the same way.  The
engine tests serve a reduced dense config through the kernels, with a
bf16 and with a quantized pool.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.kernels.kv_quant import KVQuantConfig, quantize
from repro_torch.models.model import init_params
from repro_torch.serve.config import (ChunkingConfig, EngineConfig,
                                      PagingConfig, SpeculationConfig)
from repro_torch.serve.engine import Engine

pytestmark = pytest.mark.cuda
ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2


def _assert_agree(out, ref):
    o, r = out.float(), ref.float()
    torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert torch.all(row <= ROW_TOL), row.max()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _table(rng, rows_len, page, pps, n_frames):
    table = np.full((len(rows_len), pps), n_frames - 1, np.int32)
    perm = rng.permutation(n_frames - 1)
    at = 0
    for r, n in enumerate(rows_len):
        used = -(-n // page)
        table[r, :used] = perm[at:at + used]
        at += used
    return table


@pytest.mark.parametrize("groups,head_dim,page", [(3, 128, 16), (1, 64, 8),
                                                  (8, 128, 16), (2, 64, 16)])
def test_decode_kernel_matches_plain(dev, groups, head_dim, page):
    rng = np.random.default_rng(0)
    hkv = 4
    lengths = np.array([1, page, page + 1, 63, 64, 65, 200], np.int32)
    pps = 256 // page
    n_frames = len(lengths) * pps + 1
    pt = torch.from_numpy(_table(rng, lengths, page, pps, n_frames)).to(dev)
    kp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    vp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    q = torch.randn(len(lengths), hkv * groups, head_dim,
                    device=dev).bfloat16()
    ln = torch.from_numpy(lengths).to(dev)
    before = decode_attention.KERNEL.launches
    out = ops.paged_decode_attention(q, kp, vp, pt, ln)
    ref = ops.paged_decode_attention(q, kp, vp, pt, ln, impl="torch")
    assert decode_attention.KERNEL.launches == before + 1
    _assert_agree(out, ref)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_prefill_kernel_matches_plain(dev, window, head_dim):
    rng = np.random.default_rng(1)
    hkv, groups, page, T = 2, 3, 16, 100
    offset = np.array([0, 48, 131, 0], np.int32)
    length = np.array([100, 71, 9, 0], np.int32)
    pps = 512 // page
    n_frames = len(offset) * pps + 1
    rows = torch.from_numpy(_table(rng, offset + length, page, pps,
                                   n_frames)).to(dev)
    kp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    vp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    q = torch.randn(len(offset), T, hkv * groups, head_dim,
                    device=dev).bfloat16()
    off = torch.from_numpy(offset).to(dev)
    ln = torch.from_numpy(length).to(dev)
    before = flash_attention.KERNEL.launches
    out = ops.paged_prefill_attention(q, kp, vp, rows, off, ln, window=window)
    ref = ops.paged_prefill_attention(q, kp, vp, rows, off, ln,
                                      window=window, impl="torch")
    assert flash_attention.KERNEL.launches == before + 1
    for c, n in enumerate(length):
        _assert_agree(out[c, :n], ref[c, :n])


@pytest.mark.parametrize("groups,head_dim,page,rows", [
    (3, 128, 16, 5), (1, 64, 8, 3), (8, 128, 16, 5), (2, 64, 16, 2),
    (3, 128, 16, 8)])
def test_verify_kernel_matches_plain_and_decode_kernel(dev, groups, head_dim,
                                                       page, rows):
    """Every row against the plain version, and row s against the decode
    kernel at ``lengths[:, s]``: the same template, so the same bits.
    ``rows`` = 8 at G = 3 spans two row groups of the grid."""
    rng = np.random.default_rng(3)
    hkv = 4
    base = np.array([0, page - 1, page, 63, 64, 150], np.int32)
    lengths = (base[:, None] + np.arange(rows)[None, :] + 1).astype(np.int32)
    B, pps = len(base), 256 // page
    n_frames = B * pps + 1
    pt = torch.from_numpy(_table(rng, lengths[:, -1], page, pps,
                                 n_frames)).to(dev)
    kp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    vp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    q = torch.randn(B, rows, hkv * groups, head_dim, device=dev).bfloat16()
    ln = torch.from_numpy(lengths).to(dev)
    before = decode_attention.VERIFY_KERNEL.launches
    out = ops.paged_verify_attention(q, kp, vp, pt, ln)
    ref = ops.paged_verify_attention(q, kp, vp, pt, ln, impl="torch")
    assert decode_attention.VERIFY_KERNEL.launches == before + 1
    _assert_agree(out, ref)
    for s in range(rows):
        one = ops.paged_decode_attention(q[:, s].contiguous(), kp, vp, pt,
                                         ln[:, s].contiguous())
        assert torch.equal(out[:, s], one), s


def test_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(2, 6, 16, device=dev, dtype=torch.bfloat16)
    pool = torch.zeros(5, 4, 2, 16, device=dev, dtype=torch.bfloat16)
    pt = torch.full((2, 2), 4, dtype=torch.int32, device=dev)
    ln = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(q, pool, pool, pt, ln)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q.float(), pool, pool, pt, ln)
    with pytest.raises(ValueError, match="lengths"):
        ops.paged_verify_attention(q[:, None], pool, pool, pt, ln)


def _quant_pools(n_frames, page, hkv, head_dim, mode, dev):
    """int8 / fp8 K and V pools quantized from normal draws with absmax
    scales per (frame, KV head); returns (k, v, scale keywords)."""
    qcfg = KVQuantConfig(mode)
    made = []
    for _ in range(2):
        x = torch.randn(n_frames, page, hkv, head_dim, device=dev)
        s = x.abs().amax(dim=(1, 3)) * qcfg.inv_qmax
        made += [quantize(x, s[:, None, :, None], qcfg), s.contiguous()]
    return made[0], made[2], {"k_scales": made[1], "v_scales": made[3]}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("groups,head_dim,page", [(3, 128, 16), (1, 64, 8),
                                                  (8, 128, 16)])
def test_quant_kernels_match_plain(dev, mode, groups, head_dim, page):
    """Decode, verify and prefill on a quantized pool against their plain
    versions; verify row s bitwise the decode kernel of the same element
    type at ``lengths[:, s]``; each launch counted on the pool dtype's
    entry point."""
    rng = np.random.default_rng(4)
    hkv, rows, dt = 4, 5, KVQuantConfig(mode).dtype
    base = np.array([0, page - 1, page, 63, 64, 150], np.int32)
    lengths = (base[:, None] + np.arange(rows)[None, :] + 1).astype(np.int32)
    B, pps = len(base), 256 // page
    n_frames = B * pps + 1
    pt = torch.from_numpy(_table(rng, lengths[:, -1], page, pps,
                                 n_frames)).to(dev)
    kp, vp, kw = _quant_pools(n_frames, page, hkv, head_dim, mode, dev)
    ln = torch.from_numpy(lengths).to(dev)
    q = torch.randn(B, rows, hkv * groups, head_dim, device=dev).bfloat16()
    kernels = (decode_attention.KERNELS[dt],
               decode_attention.VERIFY_KERNELS[dt], flash_attention.KERNELS[dt])
    before = [k.launches for k in kernels]
    out = ops.paged_verify_attention(q, kp, vp, pt, ln, **kw)
    _assert_agree(out, ops.paged_verify_attention(q, kp, vp, pt, ln,
                                                  impl="torch", **kw))
    for s in range(rows):
        args = (q[:, s].contiguous(), kp, vp, pt, ln[:, s].contiguous())
        one = ops.paged_decode_attention(*args, **kw)
        _assert_agree(one, ops.paged_decode_attention(*args, impl="torch",
                                                      **kw))
        assert torch.equal(out[:, s], one), s
    off = torch.from_numpy(base).to(dev)
    n = torch.full((B,), rows, dtype=torch.int32, device=dev)
    pre = ops.paged_prefill_attention(q, kp, vp, pt, off, n, **kw)
    _assert_agree(pre, ops.paged_prefill_attention(q, kp, vp, pt, off, n,
                                                   impl="torch", **kw))
    assert [k.launches - b for k, b in zip(kernels, before)] == [rows, 1, 1]


class _RepeatLast:
    """Drafts the last token k times: a draft on every step."""

    def __init__(self, n, k):
        self.k = k

    def propose(self, rid, history):
        return [history[-1]] * self.k

    def drop(self, rid):
        pass


@pytest.mark.parametrize("speculate_k", [0, 4])
def test_engine_serves_through_the_kernels(dev, speculate_k):
    """A reduced dense config with 128-wide heads (the kernels' width),
    an oversubscribed pool, every request finished, the kernels of the
    path used (with speculation, the verify kernel too)."""
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), head_dim=128)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    kernels = [decode_attention.KERNEL, flash_attention.KERNEL]
    if speculate_k:
        kernels.append(decode_attention.VERIFY_KERNEL)
    counts = [k.launches for k in kernels]
    eng = Engine(cfg, params, EngineConfig(
        max_batch=3, max_len=64, device="cuda",
        paging=PagingConfig(page_size=4, device_pages=10),
        chunking=ChunkingConfig(chunk_tokens=8, chunk_slots=2),
        speculation=SpeculationConfig(speculate_k=speculate_k,
                                      proposer_factory=_RepeatLast)))
    rng = np.random.default_rng(2)
    for n in (13, 6, 17, 9, 20, 5):
        eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=7)
    out = eng.run()
    assert sorted(len(v) for v in out.values()) == [7] * 6
    assert eng.stats["preemptions"] > 0
    assert all(k.launches > c for k, c in zip(kernels, counts))


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quant_engine_serves_through_the_kernels(dev, kv_quant):
    """The quantized pool on the card: every request finished, the pool
    preempted, and the decode, prefill and verify instances of the pool's
    element type launched."""
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), head_dim=128)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    dt = KVQuantConfig(kv_quant).dtype
    kernels = [decode_attention.KERNELS[dt], flash_attention.KERNELS[dt],
               decode_attention.VERIFY_KERNELS[dt]]
    counts = [k.launches for k in kernels]
    for speculate_k in (0, 4):
        eng = Engine(cfg, params, EngineConfig(
            max_batch=3, max_len=64, device="cuda",
            paging=PagingConfig(page_size=4, device_pages=10,
                                kv_quant=kv_quant),
            chunking=ChunkingConfig(chunk_tokens=8, chunk_slots=2),
            speculation=SpeculationConfig(speculate_k=speculate_k,
                                          proposer_factory=_RepeatLast)))
        rng = np.random.default_rng(2)
        for n in (13, 6, 17, 9, 20, 5):
            eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=7)
        out = eng.run()
        assert sorted(len(v) for v in out.values()) == [7] * 6
        assert eng.stats["preemptions"] > 0
        assert eng.cache.kv["k_pages"].dtype == dt
    assert all(k.launches > c for k, c in zip(kernels, counts))
