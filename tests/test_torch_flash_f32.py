"""The f32 dense flash kernel's design: 3xTF32 tensor-core products.

On the CPU: the plan (``flash_attention.f32_flash_plan``): its values at
``chip_smoke.py``'s f32 cases, every query row in exactly one warp's
rows and every position of a stage in exactly one warp's part, and the
block's shared memory (``f32_flash_smem``) within what an H100 block
may take, two blocks an SM at D 128.  Then the numeric premise of the
design, in an emulation of the kernel's arithmetic in plain torch: TF32
rounding by masking the low 13 bits of the mantissa (the head rounded
to nearest, ties away, the tail cut as the tensor core reads it), each
product as lo . hi + hi . lo + hi . hi, 32-position stages split
between the warps of the plan, the online softmax in base 2 and the
warps' states merged in order by the log-sum-exp rule — held against
the JAX ``flash_attention`` in interpret mode and the port's naive
``attention_ref`` at the reference's f32 bar (5e-6 of max |ref|), for
every head dim, with causal, window, q_offset and kv_valid; and one
TF32 product, which misses that bar, the reason for the split; and a
2048-long row with the tensor core's truncating accumulation emulated,
within the bar with the kernel's fresh accumulators (each 16-dim chunk
of a score, each stage's P V) and past it with one chain.

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_f32.py``):
the kernel against its plain version at that bar for every head dim,
plan, G in {1, 3}, ragged query counts and every mask; two calls give
the same bits; one launch counted per call; a plan it has not got is
refused.
"""

import math
from importlib import import_module

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import HEAD_DIMS

fa = import_module("repro_torch.kernels.flash_attention")

H100_SMS = 132
H100_SMEM_BLOCK = 232448        # bytes a block may opt in to
H100_SMEM_SM = 233472           # bytes of one SM (1 KiB a block reserved)
LOG2E = 1.4426950408889634
F32_BAR = 5e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(out, expected):
    out = np.asarray(out, np.float64)
    expected = np.asarray(expected, np.float64)
    return float(np.abs(out - expected).max() / np.abs(expected).max())


# ---- the plan ----

@pytest.mark.parametrize("B,H,Sq,expected", [
    (1, 4, 256, 1),          # bench_kernels: 64 blocks of 16 rows
    (1, 24, 2048, 4),        # phi4 causal 2048 prompt: 768 of 64
    (1, 24, 256, 2),         # phi4 256-token chunk: 192 of 32
    (8, 32, 1, 1),           # one row: the same blocks, positions split
    (8, 32, 20, 2), (64, 64, 4096, 4)])
def test_plan_values(B, H, Sq, expected):
    def blocks(wq):
        return -(-Sq // (16 * wq)) * H * B

    wq = fa.f32_flash_plan(B, H, Sq, H100_SMS)
    assert wq == expected
    # more rows a block only where the blocks still fill the card, and
    # fewer only where that adds blocks or the card needs them
    assert wq == 1 or blocks(wq) >= H100_SMS
    for more in (w for w in fa.F32_FLASH_WARPS_Q if w > wq):
        assert blocks(more) < H100_SMS or blocks(more) == blocks(wq)


@pytest.mark.parametrize("Sq", [1, 15, 16, 17, 100, 256, 2049])
@pytest.mark.parametrize("warps_q", fa.F32_FLASH_WARPS_Q)
def test_plan_covers_rows_and_positions_once(Sq, warps_q):
    """Block x warp rows cover [0, Sq) once (rows past Sq are the last
    block's padding); each warp of a query group takes its own slice of
    a stage's 32 positions."""
    rows_a_block = 16 * warps_q
    covered = np.zeros(-(-Sq // rows_a_block) * rows_a_block, np.int64)
    for qt in range(-(-Sq // rows_a_block)):
        for wq in range(warps_q):
            start = qt * rows_a_block + 16 * wq
            covered[start:start + 16] += 1
    assert (covered == 1).all() and covered.size >= Sq
    wkv = fa.F32_FLASH_WARPS // warps_q
    part = fa.F32_FLASH_BLOCK_KV // wkv
    assert part % 8 == 0                     # whole n-tiles of the mma
    seen = np.zeros(fa.F32_FLASH_BLOCK_KV, np.int64)
    for wk in range(wkv):
        seen[wk * part:(wk + 1) * part] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_smem_fits(head_dim):
    smem = fa.f32_flash_smem(head_dim)
    assert smem <= H100_SMEM_BLOCK
    assert 2 * (smem + 1024) <= H100_SMEM_SM      # two blocks an SM
    assert fa.f32_flash_stages(head_dim) >= 2
    # the K rows' padding makes their 16-byte reads conflict-free
    k_row = head_dim if head_dim % 32 == 16 else head_dim + 16
    assert k_row % 32 == 16 and (head_dim + 4) % 16 == 4


# ---- the arithmetic, emulated ----

def tf32_head(x):
    """x rounded to TF32 (11 significant bits), to nearest, ties away
    from zero: the kernel's ``split``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """x as the tensor core reads a TF32 operand: low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def product(a, b, three: bool = True):
    """a @ b as the kernel's mma chain computes it: 3xTF32 (the two small
    products first), or one TF32 product."""
    ah, bh = tf32_head(a), tf32_head(b)
    if not three:
        return ah @ bh
    al, bl = tf32_cut(a - ah), tf32_cut(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate(q, k, v, *, causal=True, window=0, q_offset=0, kv_valid=None,
            warps_q=4, three=True):
    """The f32 kernel's arithmetic in torch: q (B, Sq, H, D), k/v (B, Skv,
    Hkv, D) f32; stages of 32 positions, each split between the 4 /
    warps_q warps of a query group, rows zero past kv_valid."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_valid = Skv if kv_valid is None else min(kv_valid, Skv)
    scale2 = (torch.tensor(1 / math.sqrt(D), dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32))
    qs = (q * scale2).transpose(1, 2)                      # (B, H, Sq, D)
    kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
              for t in (k, v))                             # (B, H, Skv, D)
    wkv = fa.F32_FLASH_WARPS // warps_q
    part = fa.F32_FLASH_BLOCK_KV // wkv
    q_pos = q_offset + torch.arange(Sq)
    states = [(torch.full((B, H, Sq), -1e30), torch.zeros(B, H, Sq),
               torch.zeros(B, H, Sq, D)) for _ in range(wkv)]
    for tile in range(-(-kv_valid // fa.F32_FLASH_BLOCK_KV)):
        for wk in range(wkv):
            pos = tile * fa.F32_FLASH_BLOCK_KV + wk * part + torch.arange(part)
            live = pos < kv_valid
            kt = torch.zeros(B, H, part, D)
            vt = torch.zeros(B, H, part, D)
            kt[:, :, live] = kr[:, :, pos[live]]
            vt[:, :, live] = vr[:, :, pos[live]]
            s = product(qs, kt.transpose(-1, -2), three)   # (B, H, Sq, part)
            mask = live[None, :].expand(Sq, part)
            if causal:
                mask = mask & (pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, torch.tensor(-1e30))
            m, l, o = states[wk]
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            states[wk] = (m_new, l * corr + p.sum(-1),
                          o * corr[..., None] + product(p, vt, three))
    big = torch.stack([m for m, _, _ in states]).amax(0)
    den, num = torch.zeros_like(big), torch.zeros(B, H, Sq, D)
    for m, l, o in states:
        w = torch.exp2(m - big)
        den, num = den + l * w, num + o * w[..., None]
    return (num / den.clamp_min(1e-30)[..., None]).transpose(1, 2)


def exact_attention(q, k, v, *, causal, window, q_offset):
    """The same function in float64, for the error of the f32 ones."""
    H, Hkv = q.shape[2], k.shape[2]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    kd, vd = (t.repeat_interleave(H // Hkv, dim=1) for t in (kd, vd))
    s = qd @ kd.transpose(-1, -2) / math.sqrt(q.shape[-1])
    q_pos = q_offset + torch.arange(q.shape[1])[:, None]
    kv_pos = torch.arange(k.shape[1])[None, :]
    mask = torch.ones_like(q_pos == kv_pos)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    s = torch.where(mask, s, torch.tensor(-1e300, dtype=torch.float64))
    return (torch.softmax(s, -1) @ vd).transpose(1, 2)


#: (causal, window, q_offset, kv_valid): a prompt, a chunk deep in a
#: cache with a short kv_valid, a window, and cross attention
MASKS = [(True, 0, 0, None), (True, 0, 40, 70), (True, 24, 16, None),
         (False, 0, 0, 50)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_emulated_kernel_meets_the_f32_bar(head_dim, mask):
    """Every plan's 3xTF32 arithmetic is within 5e-6 of max |ref| of the
    JAX kernel in interpret mode and of the naive reference; one TF32
    product is not."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    causal, window, q_offset, kv_valid = mask
    B, H, Hkv, Sq, Skv = 1, 4, 2, 64, 96
    rng = np.random.default_rng(head_dim + q_offset + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, head_dim), (B, Skv, Hkv, head_dim),
                         (B, Skv, Hkv, head_dim)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid)
    jax_out = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="interpret",
        bq=32, bkv=32, **{n: x for n, x in kw.items() if x is not None}))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    cut = Skv if kv_valid is None else kv_valid
    naive = ref.attention_ref(tq, tk[:, :cut], tv[:, :cut], causal=causal,
                              window=window, q_offset=q_offset).numpy()
    exact = exact_attention(tq, tk[:, :cut], tv[:, :cut], causal=causal,
                            window=window, q_offset=q_offset).numpy()
    for warps_q in fa.F32_FLASH_WARPS_Q:
        out = emulate(tq, tk, tv, warps_q=warps_q, **kw).numpy()
        assert np.isfinite(out).all()
        for what, expected in (("interpret", jax_out), ("ref", naive),
                               ("f64", exact)):
            assert _rel(out, expected) < F32_BAR, (warps_q, what)
    one = emulate(tq, tk, tv, three=False, **kw).numpy()
    assert _rel(one, exact) > F32_BAR


def _toward_zero(x):
    """float64 x rounded to f32 toward zero, as the tensor core rounds
    the sums it accumulates."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


def _mma_3x(c, a, b):
    """c + a @ b over one k-step of 8 in 3xTF32, each of the three mma
    products summed exactly and added to c with rounding toward zero."""
    ah, bh = tf32_head(a), tf32_head(b)
    al, bl = tf32_cut(a - ah), tf32_cut(b - bh)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        c = _toward_zero(c.double() + x.double() @ y.double())
    return c


def long_row(fresh: bool, seed: int = 0, D: int = 128):
    """16 query rows at 1792 over a 2048-long causal cache, one head, in
    the kernel's order with truncating accumulators: fresh (a score's
    16-dim chunks and a stage's P V from zero, joined in f32) or one
    chain through every chunk and stage.  Returns max |err| / max |ref|
    against float64."""
    g = torch.Generator().manual_seed(seed)
    Sq, Skv, off = 16, 2048, 1792
    q, k, v = (torch.randn(n, D, generator=g) for n in (Sq, Skv, Skv))
    scale2 = (torch.tensor(1 / math.sqrt(D), dtype=torch.float32)
              * torch.tensor(LOG2E, dtype=torch.float32))
    qs = q * scale2
    exact = exact_attention(q[None, :, None], k[None, :, None],
                            v[None, :, None], causal=True, window=0,
                            q_offset=off)[0, :, 0]
    visible = torch.arange(Skv)[None, :] <= off + torch.arange(Sq)[:, None]
    m, l, o = torch.full((Sq,), -1e30), torch.zeros(Sq), torch.zeros(Sq, D)
    for p0 in range(0, Skv, fa.F32_FLASH_BLOCK_KV):
        kt = k[p0:p0 + fa.F32_FLASH_BLOCK_KV]
        vt = v[p0:p0 + fa.F32_FLASH_BLOCK_KV]
        s = torch.zeros(Sq, kt.shape[0])
        for c in range(D // 16):
            part = torch.zeros_like(s) if fresh else s
            for kk in (2 * c, 2 * c + 1):
                part = _mma_3x(part, qs[:, 8 * kk:8 * kk + 8],
                               kt[:, 8 * kk:8 * kk + 8].T)
            s = s + part if fresh else part
        s = torch.where(visible[:, p0:p0 + kt.shape[0]], s,
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr, p = torch.exp2(m - m_new), torch.exp2(s - m_new[:, None])
        l, m = l * corr + p.sum(-1), m_new
        pv = torch.zeros(Sq, D) if fresh else o * corr[:, None]
        for kk in range(kt.shape[0] // 8):
            pv = _mma_3x(pv, p[:, 8 * kk:8 * kk + 8], vt[8 * kk:8 * kk + 8])
        o = torch.addcmul(pv, o, corr[:, None]) if fresh else pv
    return _rel((o / l[:, None]).numpy(), exact.numpy())


def test_fresh_accumulators_keep_a_long_row_within_the_bar():
    """The tensor core truncates as it accumulates: the kernel's fresh
    accumulators (a score's 16-dim chunks, a stage's P V) keep a row of
    2048 positions within the f32 bar, where one chain drifts past it."""
    assert long_row(fresh=True) < F32_BAR / 4
    assert long_row(fresh=False) > F32_BAR


def test_tf32_split_is_exact_and_rounds_to_nearest():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32) * 1e3)
    hi = tf32_head(x)
    assert not (hi.view(torch.int32) & 0x1fff).any()
    assert torch.equal(hi + (x - hi), x)                 # the tail is exact
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)
    assert ((x - hi).abs() <= ulp / 2).all()
    # the kernel's reading of the tail loses under 2^-21 of x
    lo = x - hi
    assert ((lo - tf32_cut(lo)).abs() <= x.abs() * 2.0 ** -21).all()


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = before


def _card_rel(out, expected):
    o, r = out.double(), expected.double()
    assert torch.isfinite(o).all()
    return float((o - r).abs().max() / r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("warps_q", [None, *fa.F32_FLASH_WARPS_Q])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,causal,window,q_offset,kv_valid", [
    (1, 4, 2, 256, 256, True, 0, 0, None),       # bench_kernels
    (2, 6, 2, 100, 100, True, 0, 0, None),       # ragged, G 3
    (1, 3, 3, 77, 300, True, 0, 200, 277),       # chunk, kv_valid
    (1, 4, 2, 130, 130, True, 33, 0, None),      # window
    (2, 2, 1, 64, 200, False, 0, 0, 150),        # cross attention
])
def test_kernel_matches_plain(dev, warps_q, head_dim, B, H, Hkv, Sq, Skv,
                              causal, window, q_offset, kv_valid):
    gen = torch.Generator(device=dev).manual_seed(head_dim + Sq)
    q = torch.randn(B, Sq, H, head_dim, generator=gen, device=dev)
    k = torch.randn(B, Skv, Hkv, head_dim, generator=gen, device=dev)
    v = torch.randn(B, Skv, Hkv, head_dim, generator=gen, device=dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid)
    kernel = fa.DENSE_KERNELS[torch.float32]
    before = kernel.launches
    out = fa.flash_attention_cuda(q, k, v, warps_q=warps_q, **kw)
    assert kernel.launches == before + 1
    assert _card_rel(out, fa.flash_attention_torch(q, k, v, **kw)) < F32_BAR
    again = fa.flash_attention_cuda(q, k, v, warps_q=warps_q, **kw)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_ops_takes_the_plan_and_refuses_others(dev):
    q = torch.randn(1, 64, 4, 64, device=dev)
    k = torch.randn(1, 64, 2, 64, device=dev)
    planned = fa.f32_flash_plan(1, 4, 64, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert torch.equal(ops.flash_attention(q, k, k),
                       fa.flash_attention_cuda(q, k, k, warps_q=planned))
    with pytest.raises(ValueError, match="warps_q"):
        fa.flash_attention_cuda(q, k, k, warps_q=3)
