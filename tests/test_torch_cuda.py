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
bf16 and with a quantized pool.  The kernel-level entry points (AMU
matmul, dense flash and decode attention) are held to their plain
versions in f32 at the reference's bar, max |err| / max |ref| < 5e-6
(f32 products without TF32), and in bf16 at the bars above; the
attention kernels also at the head shapes of the other registered
configs (G 5 and 12, head dims 16, 32 and 80).  The linear recurrences
(wkv6, ssd) are held to their plain chunked versions in f32 at the
reference's kernel-vs-chunked bar, < 1e-5, and to the sequential
oracles at < 1e-4 (``tests/test_kernels.py:117-158``), in bf16 at the
bars above; with a state in and out too (the final state at the f32
bar), and a sequence served in two halves with the state carried
between them against the whole.  The indexed gathers (gather_rows, gather_blocks) only move
bits, so they are held to their plain versions bitwise, the reference's
bar (``tests/test_kernels.py:174``, ``:183``), on the 16-byte vector path
and the element path; the MoE block must give the same bits with its
gathers on the kernel as with them plain, and the same bits twice.
"""

import dataclasses
from importlib import import_module

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import (amu_matmul, mamba2, moe_gather, ops, ref,
                                 rwkv6)
from repro_torch.kernels.kv_quant import KVQuantConfig, quantize
from repro_torch.models import moe
from repro_torch.models.model import init_params
from repro_torch.serve.config import (ChunkingConfig, EngineConfig,
                                      PagingConfig, SpeculationConfig)
from repro_torch.serve.engine import Engine

pytestmark = pytest.mark.cuda
# the kernel modules by name: the package's attributes of these names are
# the ops entry points, as in the JAX package
decode_attention = import_module("repro_torch.kernels.decode_attention")
flash_attention = import_module("repro_torch.kernels.flash_attention")
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
    q = torch.zeros(2, 6, 96, device=dev, dtype=torch.bfloat16)
    pool = torch.zeros(5, 4, 2, 96, device=dev, dtype=torch.bfloat16)
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


def _assert_dense_agree(out, ref):
    """f32: the reference's bar, max |err| / max |ref| < 5e-6; bf16: the
    bars of the paged kernels."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if out.dtype == torch.float32:
        rel = float((out - ref).abs().max() / ref.abs().max())
        assert rel < 5e-6, rel
    else:
        _assert_agree(out, ref)


@pytest.fixture
def full_f32(dev):
    """f32 products in full f32 on the card (no TF32), for the plain
    versions the f32 kernels are held to."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,tiles", [
    (256, 512, 256, dict(bm=128, bk=128, bn=128)),   # f32: two K sub-steps
    (384, 768, 128, dict(bm=128, bk=256, bn=128)),
    (128, 128, 128, dict(bm=128, bk=128, bn=128)),   # one tile, n_k == 1
    (128, 384, 512, {}),                             # the planner's tiles
    (8, 128, 64, {}),                                # 8 threads a block
])
def test_dense_matmul_kernel_matches_plain(full_f32, dtype, M, K, N, tiles):
    dev = full_f32
    x = torch.randn(M, K, device=dev).to(dtype)
    w = torch.randn(K, N, device=dev).to(dtype)
    kernel = amu_matmul.KERNELS[dtype]
    before = kernel.launches
    out = ops.matmul(x, w, **tiles)
    assert kernel.launches == before + 1
    _assert_dense_agree(out, ops.matmul(x, w, impl="torch"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window,q_offset,kv_valid", [
    (2, 4, 2, 100, 100, 64, True, 0, 0, None),       # ragged query tile
    (1, 8, 2, 192, 192, 128, True, 48, 0, None),     # GQA 4:1 + SWA
    (1, 2, 2, 128, 256, 64, False, 0, 0, None),      # non-causal, Skv != Sq
    (1, 4, 4, 256, 256, 32, True, 0, 0, None),       # D = 32
    (2, 6, 2, 64, 256, 64, True, 0, 128, 160),       # offset, short kv_valid
    (1, 6, 2, 64, 256, 128, True, 40, 64, 200),      # the same with SWA
])
def test_dense_flash_kernel_matches_plain(full_f32, dtype, B, H, Hkv, Sq,
                                          Skv, D, causal, window, q_offset,
                                          kv_valid):
    dev = full_f32
    q = torch.randn(B, Sq, H, D, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, D, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, D, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid)
    kernel = flash_attention.DENSE_KERNELS[dtype]
    before = kernel.launches
    out = ops.flash_attention(q, k, v, **kw)
    assert kernel.launches == before + 1
    _assert_dense_agree(out, ops.flash_attention(q, k, v, impl="torch", **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,valid", [
    (2, 8, 2, 512, 64, 512), (1, 4, 4, 256, 128, 200),
    (2, 16, 4, 256, 64, 33), (2, 6, 2, 100, 32, 77), (3, 24, 8, 300, 128, 1)])
def test_dense_decode_kernel_matches_plain(full_f32, dtype, B, H, Hkv, S, D,
                                           valid):
    dev = full_f32
    q = torch.randn(B, H, D, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=dev).to(dtype)
    kernel = decode_attention.DENSE_KERNELS[dtype]
    before = kernel.launches
    out = ops.decode_attention(q, k, v, valid_len=valid)
    assert kernel.launches == before + 1
    _assert_dense_agree(out, ops.decode_attention(q, k, v, valid_len=valid,
                                                  impl="torch"))


def test_dense_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros(256, 512, device=dev)
    with pytest.raises(ValueError, match="must tile"):
        ops.matmul(x, torch.zeros(512, 384, device=dev), bm=128, bk=128,
                   bn=256)
    with pytest.raises(ValueError, match="cannot hold"):
        ops.matmul(x, torch.zeros(512, 256, device=dev), bm=4, bk=128,
                   bn=256)
    with pytest.raises(TypeError):
        ops.matmul(x.half(), torch.zeros(512, 256, device=dev).half())
    q = torch.zeros(1, 64, 4, 96, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="groups"):
        ops.decode_attention(torch.zeros(1, 5, 64, device=dev),
                             torch.zeros(1, 8, 2, 64, device=dev),
                             torch.zeros(1, 8, 2, 64, device=dev))


#: (G, D) of the registered configs that the kernels took only after
#: the shape-set repair: llama4 (G 5), command-r-plus (G 12), h2o-danube
#: (D 80), the SMOKE configs (D 16, 32)
NEW_SHAPES = [(5, 128), (12, 128), (4, 80), (3, 16), (2, 32)]


@pytest.mark.parametrize("groups,head_dim", NEW_SHAPES)
def test_paged_kernels_take_the_configs_heads(dev, groups, head_dim):
    """Decode, verify and prefill at the new (G, D) against their plain
    versions; verify row s bitwise the decode kernel at lengths[:, s]."""
    rng = np.random.default_rng(groups * head_dim)
    hkv, page, rows = 2, 16, 5
    base = np.array([0, page - 1, 63, 150], np.int32)
    lengths = (base[:, None] + np.arange(rows)[None, :] + 1).astype(np.int32)
    B, pps = len(base), 256 // page
    n_frames = B * pps + 1
    pt = torch.from_numpy(_table(rng, lengths[:, -1], page, pps,
                                 n_frames)).to(dev)
    kp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    vp = torch.randn(n_frames, page, hkv, head_dim, device=dev).bfloat16()
    q = torch.randn(B, rows, hkv * groups, head_dim, device=dev).bfloat16()
    ln = torch.from_numpy(lengths).to(dev)
    out = ops.paged_verify_attention(q, kp, vp, pt, ln)
    _assert_agree(out, ops.paged_verify_attention(q, kp, vp, pt, ln,
                                                  impl="torch"))
    for s in range(rows):
        args = (q[:, s].contiguous(), kp, vp, pt, ln[:, s].contiguous())
        one = ops.paged_decode_attention(*args)
        _assert_agree(one, ops.paged_decode_attention(*args, impl="torch"))
        assert torch.equal(out[:, s], one), s
    off = torch.from_numpy(base).to(dev)
    n = torch.full((B,), rows, dtype=torch.int32, device=dev)
    _assert_agree(ops.paged_prefill_attention(q, kp, vp, pt, off, n),
                  ops.paged_prefill_attention(q, kp, vp, pt, off, n,
                                              impl="torch"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups,head_dim", NEW_SHAPES)
def test_dense_attention_takes_the_configs_heads(full_f32, dtype, groups,
                                                 head_dim):
    dev = full_f32
    hkv = 2
    q = torch.randn(2, 100, hkv * groups, head_dim, device=dev).to(dtype)
    k = torch.randn(2, 100, hkv, head_dim, device=dev).to(dtype)
    v = torch.randn(2, 100, hkv, head_dim, device=dev).to(dtype)
    _assert_dense_agree(ops.flash_attention(q, k, v),
                        ops.flash_attention(q, k, v, impl="torch"))
    qd = q[:, 0].contiguous()
    _assert_dense_agree(ops.decode_attention(qd, k, v, valid_len=77),
                        ops.decode_attention(qd, k, v, valid_len=77,
                                             impl="torch"))


@pytest.mark.parametrize("tiles", [{}, dict(bm=512, bk=512, bn=1024)])
def test_f32_matmul_runs_the_reference_tiles(full_f32, tiles):
    """f32 at 1024^3 with no tiles (the reference's plan, (512, 512,
    1024)) and with that plan given: sub-tiles of it on the card."""
    dev = full_f32
    x = torch.randn(1024, 1024, device=dev)
    w = torch.randn(1024, 1024, device=dev)
    kernel = amu_matmul.KERNELS[torch.float32]
    before = kernel.launches
    out = ops.matmul(x, w, **tiles)
    assert kernel.launches == before + 1
    _assert_dense_agree(out, ops.matmul(x, w, impl="torch"))


def _ssm_case(kind, dtype, dev, B, T, H, W, N=None):
    """(call(impl), sequential oracle) of a wkv6 or ssd case drawn as the
    reference's test draws it; the decay path f32, the rest ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(T + H + W)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if kind == "wkv6":
        r, k, v = (rand(B, T, H, W).to(dtype) for _ in range(3))
        w = -torch.exp(rand(B, T, H, W) - 2)
        u = rand(H, W) * 0.1
        return ((lambda impl, c: ops.wkv6(r, k, v, w, u, impl=impl,
                                          chunk=c)),
                lambda: ref.wkv6_ref(r, k, v, w, u))
    x = rand(B, T, H, W).to(dtype)
    dt = torch.nn.functional.softplus(rand(B, T, H))
    A = torch.linspace(0.5, 4.0, H, device=dev)
    Bm, Cm = (rand(B, T, N).to(dtype) for _ in range(2))
    D = rand(H)
    return ((lambda impl, c: ops.ssd(x, dt, A, Bm, Cm, D, impl=impl,
                                     chunk=c)),
            lambda: ref.ssd_ref(x, dt, A, Bm, Cm, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,B,T,H,W,N,chunk", [
    ("wkv6", 1, 256, 2, 64, None, 64),      # bench_kernels' shape
    ("wkv6", 2, 128, 3, 32, None, 32),
    ("wkv6", 1, 64, 2, 128, None, 16),
    ("ssd", 1, 256, 2, 64, 64, 64),         # bench_kernels' shape
    ("ssd", 2, 128, 3, 32, 16, 32),
    ("ssd", 1, 256, 4, 64, 64, 128),        # zamba2's chunk
])
def test_ssm_kernels_match_plain(full_f32, dtype, kind, B, T, H, W, N,
                                 chunk):
    dev = full_f32
    call, seq = _ssm_case(kind, dtype, dev, B, T, H, W, N)
    kernel = (rwkv6 if kind == "wkv6" else mamba2).KERNELS[dtype]
    before = kernel.launches
    out = call("auto", chunk)
    assert kernel.launches == before + 1
    plain = call("torch", chunk)
    assert out.dtype == dtype and out.shape == plain.shape
    if dtype == torch.float32:
        rel = float((out - plain).abs().max() / plain.abs().max())
        assert rel < 1e-5, rel
        oracle = seq()
        rel = float((out - oracle).abs().max() / oracle.abs().max())
        assert rel < 1e-4, rel
    else:
        _assert_agree(out, plain)
    with pytest.raises(ValueError, match="not a multiple"):
        call("cuda", T // 2 + 8)


def _ssm_agree(out, ref):
    """f32 (an f32 instance's output, any final state): the reference's
    kernel-vs-chunked bar, max |err| / max |ref| < 1e-5; bf16: the bars
    of the paged kernels."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if out.dtype == torch.float32:
        rel = float((out - ref).abs().max() / ref.abs().max())
        assert rel < 1e-5, rel
    else:
        _assert_agree(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,B,T,H,W,N,chunk,seg", [
    ("wkv6", 1, 512, 2, 64, None, 64, None),     # the plan's segments
    ("wkv6", 2, 256, 3, 32, None, 32, 1),        # a piece a segment
    ("wkv6", 1, 64, 2, 128, None, 64, None),     # one segment
    ("ssd", 1, 512, 4, 64, 64, 128, None),       # zamba2's chunk
    ("ssd", 2, 256, 3, 32, 16, 32, 1),           # B staged for the last
    ("ssd", 1, 128, 2, 64, 32, 128, None),       # one segment
])
def test_ssm_kernels_carry_the_state(full_f32, dtype, kind, B, T, H, W, N,
                                     chunk, seg):
    """Kernels 9 and 10 with an initial state in and the final state out
    against their plain versions (output and state); the sequence in two
    halves, the state carried from the first to the second, against the
    whole; a zero state in against none."""
    dev = full_f32
    gen = torch.Generator(device=dev).manual_seed(T + H + W + 7)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if kind == "wkv6":
        mod, fn, S_shape = rwkv6, ops.wkv6, (B, H, W, W)
        r, k, v = (rand(B, T, H, W).to(dtype) for _ in range(3))
        args = (r, k, v, -torch.exp(rand(B, T, H, W) - 2),
                rand(H, W) * 0.1)
        timed = (0, 1, 2, 3)                # the inputs with a T axis
    else:
        mod, fn, S_shape = mamba2, ops.ssd, (B, H, N, W)
        args = (rand(B, T, H, W).to(dtype),
                torch.nn.functional.softplus(rand(B, T, H)),
                torch.linspace(0.5, 4.0, H, device=dev),
                rand(B, T, N).to(dtype), rand(B, T, N).to(dtype), rand(H))
        timed = (0, 1, 3, 4)
    cuda = mod.wkv6_cuda if kind == "wkv6" else mod.ssd_cuda
    S0 = rand(*S_shape)
    kernel = mod.KERNELS[dtype]
    before = kernel.launches
    out, S = cuda(*args, chunk=chunk, seg=seg, initial_state=S0,
                  return_state=True)
    assert kernel.launches == before + 1
    assert S.dtype == torch.float32 and tuple(S.shape) == S_shape
    pout, pS = fn(*args, impl="torch", chunk=chunk, initial_state=S0,
                  return_state=True)
    _ssm_agree(out, pout)
    _ssm_agree(S, pS)

    def part(lo, hi):
        return tuple(a[:, lo:hi].contiguous() if i in timed else a
                     for i, a in enumerate(args))
    o1, S1 = fn(*part(0, T // 2), chunk=chunk, initial_state=S0,
                return_state=True)
    o2, S2 = fn(*part(T // 2, T), chunk=chunk, initial_state=S1,
                return_state=True)
    assert kernel.launches == before + 3
    _ssm_agree(torch.cat([o1, o2], 1), out)
    _ssm_agree(S2, S)
    zero, _ = fn(*args, chunk=chunk, initial_state=torch.zeros_like(S0),
                 return_state=True)
    _ssm_agree(zero, fn(*args, chunk=chunk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,M,rpb", [
    (64, 128, 32, 8), (128, 256, 64, 16), (32, 128, 8, 8),  # reference's
    (9, 2048, 512, 8),                 # olmoe decode dispatch
    (50, 3, 12, 4),                    # rows of 3 elements: element path
    (40, 7, 6, 1),
])
def test_gather_rows_kernel_bitwise_plain(dev, dtype, N, d, M, rpb):
    gen = torch.Generator(device=dev).manual_seed(N + M)
    src = torch.randn(N, d, generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, N, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    kernel = moe_gather.KERNELS[dtype]
    before = kernel.launches
    out = ops.gather_rows(src, idx, rows_per_block=rpb)
    assert kernel.launches == before + 1
    assert torch.equal(out, ops.gather_rows(src, idx, impl="torch",
                                            rows_per_block=rpb))
    # a source view that starts 4 bytes into its storage: element path
    off = torch.randn(N * d + 1, generator=gen, device=dev).to(dtype)[1:]
    off = off.view(N, d)
    assert torch.equal(ops.gather_rows(off, idx, impl="cuda",
                                       rows_per_block=rpb), off[idx.long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,Mb,rows", [(64, 128, 6, 8),
                                         (448 * 16, 1024, 128, 16),
                                         (30, 5, 4, 3)])
def test_gather_blocks_kernel_bitwise_plain(dev, dtype, N, d, Mb, rows):
    gen = torch.Generator(device=dev).manual_seed(Mb)
    src = torch.randn(N, d, generator=gen, device=dev).to(dtype)
    bidx = torch.randint(0, N // rows, (Mb,), generator=gen, device=dev,
                         dtype=torch.int32)
    kernel = moe_gather.BLOCK_KERNELS[dtype]
    before = kernel.launches
    out = moe_gather.gather_blocks(src, bidx, block_rows=rows)
    assert kernel.launches == before + 1
    assert torch.equal(out, moe_gather.gather_blocks(src, bidx,
                                                     block_rows=rows,
                                                     impl="torch"))


def test_gather_kernels_reject_what_they_do_not_take(dev):
    src = torch.zeros(16, 8, device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="idx"):
        ops.gather_rows(src, idx.long())
    with pytest.raises(TypeError, match="src"):
        ops.gather_rows(src.half(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_rows(src.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="idx is on"):
        ops.gather_rows(src, idx.cpu())


@pytest.mark.parametrize("B,S", [(8, 1), (2, 64), (3, 5)])
def test_moe_block_kernel_gathers_bitwise_plain(dev, B, S):
    """The MoE block with both gathers on the kernel gives the bits it
    gives with them plain, and the same bits on a second run (the
    combine sums in a fixed order, no atomics)."""
    cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), d_model=256,
                              d_ff=128, num_experts=16, experts_per_token=4)
    gen = torch.Generator(device=dev).manual_seed(B * S)
    p = moe.moe_init(cfg, gen, dev)
    p = {**p, **{n: p[n].bfloat16() for n in ("gate", "up", "down")}}
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).bfloat16()
    kernel = moe_gather.KERNELS[torch.bfloat16]
    before = kernel.launches
    out, aux = moe.moe_block(p, cfg, x)
    assert kernel.launches == before + 2
    plain, plain_aux = moe.moe_block(p, cfg, x, impl="torch")
    again, _ = moe.moe_block(p, cfg, x)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, plain) and torch.equal(aux, plain_aux)
    assert torch.equal(out, again)


def test_moe_engine_serves_through_the_kernels(dev):
    """The olmoe SMOKE config with 128-wide heads on an oversubscribed
    pool: every request finished, the paged kernels and the bf16 row
    gather launched, and a roomy pool gives the same tokens."""
    cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), head_dim=128)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    kernels = [decode_attention.KERNEL, flash_attention.KERNEL,
               moe_gather.KERNELS[torch.bfloat16]]
    counts = [k.launches for k in kernels]
    outs = []
    for pages in (10, None):
        eng = Engine(cfg, params, EngineConfig(
            max_batch=3, max_len=64, device="cuda",
            paging=PagingConfig(page_size=4, device_pages=pages),
            chunking=ChunkingConfig(chunk_tokens=8, chunk_slots=2)))
        rng = np.random.default_rng(2)
        for n in (13, 6, 17, 9, 20, 5):
            eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=7)
        outs.append(eng.run())
        assert sorted(len(v) for v in outs[-1].values()) == [7] * 6
        assert (eng.stats["preemptions"] > 0) == (pages is not None)
    assert outs[0] == outs[1]
    assert all(k.launches > c for k, c in zip(kernels, counts))
