"""The int8 / fp8 paged prefill on the tensor cores (``csrc/paged_prefill.cu``).

The kernel feeds wgmma the raw 1-byte codes widened to bf16 and applies
the per-(frame, KV head) scales outside the products: ks on the columns
of S before the mask, vs on the columns of P before P is rounded to bf16.

On the CPU:

* every int8 code and every finite ``float8_e4m3fn`` code is a bf16 value
  (exhaustive over the 256 codes of each), and the kernel's int8 route
  (a byte permute into the mantissa of 2^23, one f32 subtraction, the
  upper half) gives those bits;
* :func:`emulate`, the new arithmetic in plain torch (codes as bf16, ks
  on the score column, vs folded into P before P's bf16 rounding,
  64-position tiles at absolute multiples from each 128-row block's
  window start to its last visible position, nothing read past it),
  against ``paged_prefill_attention_torch`` and the JAX package's
  ``paged_prefill_flash`` in interpret mode with ``k_scales`` /
  ``v_scales``, at phase 2's bar (atol 4e-3 + rtol 1e-2 per element, 1e-2
  relative L2 per row) on int8 and fp8 pools, G 1 / 3, D 64 / 80 / 128,
  page 16 / 8, with and without a window;
* NaN scales on the frames past every row's extent leave the emulated
  output as it was: no such scale is read;
* the quantized plan (:func:`flash_attention.quant_prefill_plan`)
  mirrors the source's constants and fits the 232,448 bytes a block may
  opt in to on an H100 at every head dim in ``HEAD_DIMS``.

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_quant_prefill.py``):
the kernel against its plain version at ``tests/test_torch_flash_sm90.py``'s
paged shapes, int8 and fp8; one launch counted per call, repeat calls
bitwise equal; a chunk row computed as one chunk and as two gives the
same bits.
"""

import math
import re
from importlib import import_module

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import CSRC, HEAD_DIMS
from repro_torch.kernels.kv_quant import KVQuantConfig, quantize

flash_attention = import_module("repro_torch.kernels.flash_attention")
H100_SMEM = 232448      # shared memory a block may opt in to on an H100
ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2
MODES = ("int8", "fp8")
NEG_INF = -1e30
LOG2E = 1.4426950408889634
BLOCK_Q, BLOCK_KV = flash_attention.SM90_BLOCK_Q, flash_attention.SM90_BLOCK_KV

#: the chunk rows: a full chunk of two 128-row blocks at offset 0, one at
#: a depth that starts mid-page, a short one, and an inert length-0 row
OFFSET = np.array([0, 48, 131, 0], np.int32)
LENGTH = np.array([150, 71, 9, 0], np.int32)
T, HKV, MAX_LEN = 150, 2, 256
#: CPU cases (G, D, page, window)
CASES = [(1, 64, 16, 0), (3, 80, 8, 24), (3, 128, 16, 40), (1, 128, 8, 0)]
#: cuda cases: tests/test_torch_flash_sm90.py's paged shapes (every head
#: dim, G 3, 1, 5, 4, 12, pages 16, 8, 4, windows)
PAGED = [
    (3, 128, 16, 0), (3, 128, 16, 40), (1, 64, 8, 0), (5, 128, 4, 0),
    (4, 80, 16, 0), (3, 16, 16, 0), (12, 32, 8, 24),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the codes as bf16
# ---------------------------------------------------------------------------


def _all_codes(dtype):
    return torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype)


def test_every_int8_code_is_a_bf16_value():
    codes = _all_codes(torch.int8)
    assert torch.equal(codes.to(torch.bfloat16).float(), codes.float())
    # the kernel's route (kv_types.cuh widen4): (x ^ 0x80) in the low byte
    # of the f32 2^23, less 2^23 + 128, then the upper 16 bits
    u = codes.view(torch.uint8).numpy().astype(np.uint32) ^ 0x80
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, codes.numpy().astype(np.float32))
    upper = (f.view(np.uint32) >> 16).astype(np.uint16)
    assert np.array_equal(upper, codes.to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16))
    assert (f.view(np.uint32) & 0xFFFF == 0).all()


def test_every_finite_e4m3_code_is_a_bf16_value():
    codes = _all_codes(torch.float8_e4m3fn)
    f32 = codes.float()
    finite = torch.isfinite(f32)
    assert int(finite.sum()) == 254              # 0x7F and 0xFF are NaN
    # the kernel's route: f16 (cvt.rn.f16x2.e4m3x2), f32, bf16
    via = codes.to(torch.float16).float().to(torch.bfloat16).float()
    assert torch.equal(via[finite], f32[finite])
    assert torch.equal(codes.to(torch.bfloat16).float()[finite], f32[finite])
    # -0 stays -0, and the zero byte is +0
    assert torch.equal(torch.signbit(via[finite]), torch.signbit(f32[finite]))
    assert not torch.signbit(f32[0])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1))


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_quant_plan_fits_and_mirrors_the_source(head_dim):
    """The plan is the source's ``QuantPlan<D>``: the bf16 plan's q tile,
    stages and barriers, each stage's 64 k and 64 v scales, then the raw
    ring of a tile's 1-byte K and V rows and scales; it fits one block."""
    src = (CSRC / "paged_prefill.cu").read_text()
    hdr = (CSRC / "flash_sm90.cuh").read_text()
    stages, block_kv = _const(hdr, "kStages"), _const(hdr, "kBlockKV")
    raw_stages, producers = (_const(src, "kRawStages"),
                             _const(src, "kProducers"))
    assert raw_stages == flash_attention.QUANT_RAW_STAGES
    assert producers == flash_attention.QUANT_PRODUCERS == 128
    assert _const(hdr, "kSmemOptin") == H100_SMEM
    # setmaxnreg hands the producers' registers to the consumers: the
    # launch's 168 a thread of 384 in all
    regs = _const(src, "kProducerRegs") * producers \
        + _const(src, "kConsumerRegs") * 256
    assert regs == 168 * 384
    plan = flash_attention.quant_prefill_plan(head_dim)
    bf16 = flash_attention.sm90_plan(head_dim)
    bars_end = 1024 + bf16.block_q * bf16.d_pad * 2 \
        + stages * 2 * block_kv * bf16.d_pad * 2 + (2 * stages + 1) * 8
    assert bars_end == bf16.smem_bytes
    assert plan.scale_offset == -(-(bars_end - 1024) // 16) * 16
    assert plan.raw_offset == plan.scale_offset + stages * 2 * block_kv * 4
    assert plan.raw_stage_bytes == 2 * block_kv * head_dim + 2 * block_kv * 4
    assert plan.smem_bytes == 1024 + plan.raw_offset \
        + raw_stages * plan.raw_stage_bytes
    assert plan.smem_bytes <= H100_SMEM
    # every 16-byte piece a cp.async lands on a 16-byte boundary
    assert plan.raw_offset % 16 == 0 and plan.raw_stage_bytes % 16 == 0
    assert flash_attention.quant_prefill_plan.__code__.co_argcount == 1


def test_entry_points_and_source():
    """Names and registry kept: the int8 / fp8 instances still build from
    ``paged_prefill.cu``, now on the sm90 block with a cp.async ring."""
    kernels = flash_attention.KERNELS
    for dt, suffix in ((torch.int8, "int8"), (torch.float8_e4m3fn, "fp8")):
        assert kernels[dt].source.name == "paged_prefill.cu"
        assert kernels[dt].name == f"paged_prefill_attention_{suffix}"
        assert kernels[dt] in ops.KERNELS
    src = (CSRC / "paged_prefill.cu").read_text()
    assert '#include "flash_sm90.cuh"' in src
    assert "consume<D>(" in src and "cp.async" in src


# ---------------------------------------------------------------------------
# the arithmetic, emulated, against the plain version and JAX
# ---------------------------------------------------------------------------


def _table(rng, page):
    pps = MAX_LEN // page
    n_frames = len(OFFSET) * pps + 1
    table = np.full((len(OFFSET), pps), n_frames - 1, np.int32)
    perm = rng.permutation(n_frames - 1)
    at = 0
    for c, n in enumerate(OFFSET + LENGTH):
        used = -(-int(n) // page)
        table[c, :used] = perm[at:at + used]
        at += used
    return table, n_frames


def _quant_case(mode, groups, head_dim, page, seed):
    """numpy-seeded inputs: q (bf16), int8 / fp8 pools quantized from a
    standard normal draw (phase 2's, for which its bar is set) with
    per-(frame, KV head) absmax scales, the table."""
    rng = np.random.default_rng(seed)
    table, n_frames = _table(rng, page)
    q = torch.from_numpy(rng.standard_normal(
        (len(OFFSET), T, HKV * groups, head_dim)).astype(np.float32))
    cfg = KVQuantConfig(mode)
    pools, scales = [], []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal(
            (n_frames, page, HKV, head_dim)).astype(np.float32))
        s = x.abs().amax(dim=(1, 3)) * cfg.inv_qmax
        pools.append(quantize(x, s[:, None, :, None], cfg))
        scales.append(s.contiguous())
    return (q.bfloat16(), pools[0], pools[1], torch.from_numpy(table),
            scales[0], scales[1])


def emulate(q, k_pages, v_pages, page_rows, offset, lengths, k_scales,
            v_scales, window=0):
    """The quantized kernel's arithmetic in plain torch, f32: each block
    of 128 query rows walks 64-position tiles at absolute multiples of 64
    from its window's first tile (or 0) to its last visible position,
    reading nothing at or past it (zero rows, scale 0); S = q . codes,
    times ks per column, masked, base-2 online softmax; P times vs per
    column, rounded to bf16, then P . codes.  Rows past ``lengths``
    store zeros (don't-care)."""
    C, Tq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    g, pps = H // Hkv, page_rows.shape[1]
    scale_log2 = float(np.float32(1.0 / math.sqrt(D)) * np.float32(LOG2E))
    kf, vf = k_pages.float(), v_pages.float()        # the codes, exactly
    out = torch.zeros(C, Tq, H, D)
    for c in range(C):
        off, ln = int(offset[c]), int(lengths[c])
        for t0 in range(0, Tq, BLOCK_Q):
            if t0 >= ln:
                continue
            first_q = off + t0
            hi = off + min(t0 + BLOCK_Q, ln)           # last visible + 1
            lo = (max(0, first_q - window + 1) // BLOCK_KV * BLOCK_KV
                  if window > 0 else 0)
            qb = q[c, t0:t0 + BLOCK_Q].float()          # (bq, H, D)
            q_pos = first_q + torch.arange(qb.shape[0])
            m = torch.full((qb.shape[0], H), NEG_INF)
            l = torch.zeros(qb.shape[0], H)
            o = torch.zeros(qb.shape[0], H, D)
            for k0 in range(lo, hi, BLOCK_KV):
                pos = k0 + torch.arange(BLOCK_KV)
                live = pos < hi
                frame = page_rows[c, torch.clamp(pos // page, max=pps - 1)]
                frame = torch.where(live, frame, 0).long()
                row = pos % page
                kt = torch.where(live[:, None, None], kf[frame, row], 0.)
                vt = torch.where(live[:, None, None], vf[frame, row], 0.)
                ks = torch.where(live[:, None], k_scales[frame], 0.)
                vs = torch.where(live[:, None], v_scales[frame], 0.)
                kh = kt.repeat_interleave(g, dim=1)         # (64, H, D)
                vh = vt.repeat_interleave(g, dim=1)
                s = torch.einsum("qhd,khd->qhk", qb, kh)
                s = s * ks.repeat_interleave(g, dim=1).T[None]
                vis = (pos[None, :] < off + ln) \
                    & (pos[None, :] <= q_pos[:, None])
                if window > 0:
                    vis = vis & (pos[None, :] > q_pos[:, None] - window)
                s = torch.where(vis[:, None, :], s * scale_log2,
                                torch.tensor(NEG_INF))
                mx = torch.maximum(m, s.amax(dim=-1))
                corr = torch.where(mx == m, torch.tensor(1.0),
                                   torch.exp2(m - mx))
                p = torch.exp2(s - mx[..., None])
                l = l * corr + p.sum(dim=-1)
                m = mx
                pv = (p * vs.repeat_interleave(g, dim=1).T[None])
                pv = pv.bfloat16().float()
                o = o * corr[..., None] + torch.einsum("qhk,khd->qhd", pv,
                                                       vh)
            out[c, t0:t0 + BLOCK_Q] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.bfloat16()


def _agree(out, ref):
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert torch.all(row <= ROW_TOL), row.max()


def _jax_pool(pool):
    import jax
    import jax.numpy as jnp

    raw = jnp.asarray(pool.view(torch.uint8).numpy())
    dt = jnp.int8 if pool.dtype == torch.int8 else jnp.float8_e4m3fn
    return jax.lax.bitcast_convert_type(raw, dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("groups,head_dim,page,window", CASES)
def test_emulation_matches_plain_and_jax(mode, groups, head_dim, page,
                                         window):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    q, kp, vp, table, ks, vs = _quant_case(mode, groups, head_dim, page,
                                           head_dim + page + window)
    off, ln = torch.from_numpy(OFFSET), torch.from_numpy(LENGTH)
    out = emulate(q, kp, vp, table, off, ln, ks, vs, window)
    plain = ops.paged_prefill_attention(q, kp, vp, table, off, ln,
                                        window=window, k_scales=ks,
                                        v_scales=vs)
    assert plain.dtype == torch.bfloat16
    expected = np.asarray(jops.paged_prefill_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), _jax_pool(kp),
        _jax_pool(vp), jnp.asarray(table.numpy()), jnp.asarray(OFFSET),
        jnp.asarray(LENGTH), window=window, impl="interpret",
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy())),
        np.float32)
    for c, n in enumerate(LENGTH):
        _agree(out[c, :n], plain[c, :n])
        _agree(out[c, :n], torch.from_numpy(expected[c, :n]))


@pytest.mark.parametrize("mode", MODES)
def test_nan_scales_past_every_extent_are_never_read(mode):
    """Frames that hold no position below any row's extent (the trash
    frame and the unused ones) get NaN scales: the emulated output, which
    reads scales only below each block's last visible position, keeps
    every bit."""
    q, kp, vp, table, ks, vs = _quant_case(mode, 3, 128, 16, 5)
    off, ln = torch.from_numpy(OFFSET), torch.from_numpy(LENGTH)
    live = set()
    for c, (o, n) in enumerate(zip(OFFSET, LENGTH)):
        live.update(int(f) for f in table[c, :-(-int(o + n) // 16)])
    dead = [f for f in range(kp.shape[0]) if f not in live]
    assert table.numpy().max() in dead                 # the trash frame
    nks, nvs = ks.clone(), vs.clone()
    nks[dead] = float("nan")
    nvs[dead] = float("nan")
    out = emulate(q, kp, vp, table, off, ln, nks, nvs)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, emulate(q, kp, vp, table, off, ln, ks, vs))


# ---------------------------------------------------------------------------
# cuda: the kernel against its plain version, bits across calls and splits
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _on(dev, mode, groups, head_dim, page, seed=11):
    return [t.to(dev) for t in _quant_case(mode, groups, head_dim, page,
                                           seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("groups,head_dim,page,window", PAGED)
def test_quant_kernel_matches_plain(dev, mode, groups, head_dim, page,
                                    window):
    q, kp, vp, pt, ks, vs = _on(dev, mode, groups, head_dim, page)
    off = torch.from_numpy(OFFSET).to(dev)
    ln = torch.from_numpy(LENGTH).to(dev)
    kw = dict(window=window, k_scales=ks, v_scales=vs)
    kernel = flash_attention.KERNELS[kp.dtype]
    before = kernel.launches
    out = ops.paged_prefill_attention(q, kp, vp, pt, off, ln, **kw)
    again = ops.paged_prefill_attention(q, kp, vp, pt, off, ln, **kw)
    assert kernel.launches == before + 2
    ref = ops.paged_prefill_attention(q, kp, vp, pt, off, ln, impl="torch",
                                      **kw)
    for c, n in enumerate(LENGTH):
        _agree(out[c, :n], ref[c, :n])
    assert torch.equal(out, again)
    # the emulated arithmetic, at the same bar
    emu = emulate(*(t.cpu() for t in (q, kp, vp, pt, off, ln, ks, vs)),
                  window)
    for c, n in enumerate(LENGTH):
        _agree(out[c, :n].cpu(), emu[c, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("groups,head_dim,page,window", PAGED)
def test_quant_chunk_split_gives_the_same_bits(dev, mode, groups, head_dim,
                                               page, window):
    """Each chunk row as one chunk and as two (a cut off the tile width,
    the second chunk beside another row in its launch): the same bits,
    what a preempted sequence's re-prefill relies on."""
    q, kp, vp, pt, ks, vs = _on(dev, mode, groups, head_dim, page)
    off = torch.from_numpy(OFFSET).to(dev)
    ln = torch.from_numpy(LENGTH).to(dev)
    kw = dict(window=window, k_scales=ks, v_scales=vs)
    whole = ops.paged_prefill_attention(q, kp, vp, pt, off, ln, **kw)
    for c, n in enumerate(LENGTH):
        if n < 2:
            continue
        cut = int(n) * 3 // 7
        first = ops.paged_prefill_attention(
            q[c:c + 1, :cut].contiguous(), kp, vp, pt[c:c + 1], off[c:c + 1],
            ln.new_tensor([cut]), **kw)
        rows = torch.stack([pt[c], pt[0]])
        q2 = torch.zeros_like(q[:2])
        q2[0, :n - cut] = q[c, cut:n]
        q2[1] = q[0]
        second = ops.paged_prefill_attention(
            q2, kp, vp, rows, torch.stack([off[c] + cut, off[0]]),
            ln.new_tensor([int(n) - cut, int(LENGTH[0])]), **kw)
        assert torch.equal(first[0], whole[c, :cut]), c
        assert torch.equal(second[0, :n - cut], whole[c, cut:n]), c
        assert torch.equal(second[1, :LENGTH[0]], whole[0, :LENGTH[0]])
