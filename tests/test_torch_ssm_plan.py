"""The chunk-parallel recurrence kernels' design: plans and arithmetic.

On the CPU: the plans (``rwkv6.wkv6_plan``, ``mamba2.ssd_plan``): pieces
tile every chunk and segments tile T, a block's shared memory within an
H100's at every width and chunk, and at rwkv6-7b's and zamba2-1.2b's
widths a workspace within the L2 and (C) blocks that fill a wave.  Then
the kernels' arithmetic (``csrc/wkv6.cu``, ``csrc/ssd.cu``) emulated in
plain torch: the three phases over pieces and segments (each segment's
state from zero, the scan, the outputs), the decays in base 2, wkv6's
exponential reference per row sub-chunk and, inside its diagonal blocks,
per 8-row half and 4-row quarter (the pairs inside a quarter one by
one), ssd's
C B^T per piece, every product in 3xTF32 (TF32 by masking the low 13
bits of the mantissa: the head rounded to nearest, the tail cut as the
tensor core reads it; a raw bf16 operand exact, its split skipped),
each 16 of depth summed from zero with the tensor core's truncating
accumulation.  Held against the JAX reference (its XLA path, the Pallas
kernel in interpret mode at the plans' own pieces, the sequential
oracle) at the f32 bars of
``tests/test_kernels.py``, and in bf16 against the plain version at
``chip_smoke.py``'s per-element and per-row bars; at decay extremes
(w = -exp(N(0,1) + 2), w = -1e-6; for ssd A dt 50 times the test's and
1e-6 of it) every output finite, every exponent the kernels form at most
0, and the f32 bar against the sequential form in float64.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba2, rwkv6
from repro_torch.kernels.build import L2_BYTES
from repro_torch.models import ssm

H100_SMS = 132
H100_SMEM_BLOCK = 232448      # bytes a block may opt in to
F32_CHUNKED, F32_SEQ = 1e-5, 1e-4
ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2     # chip_smoke.py's bf16 bars
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _rel(out, expected):
    out = np.asarray(out, np.float64)
    expected = np.asarray(expected, np.float64)
    return float(np.abs(out - expected).max() / np.abs(expected).max())


def _bf16_bars(out, ref):
    """chip_smoke.agree: per element and per row (rows of the last axis)."""
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    assert torch.all((o - r).abs() <= ATOL + RTOL * r.abs())
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert float(row.max()) <= ROW_TOL


# ---- the plans ----

def _plan(kind, T, W, chunk, B=1, H=4, sms=H100_SMS):
    if kind == "wkv6":
        return rwkv6.wkv6_plan(B, T, H, W, W, chunk, sms)
    return mamba2.ssd_plan(B, T, H, W, 64 if W > 32 else 16, chunk, sms)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
@pytest.mark.parametrize("width", [32, 64, 128])
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_plan_tiles_the_sequence_within_shared_memory(kind, width, chunk):
    T = 1024
    plan = _plan(kind, T, width, chunk)
    assert plan.sub == 16
    assert chunk % plan.rows == 0                     # every chunk in pieces
    assert plan.segments * plan.seg * plan.rows == T  # ... once
    assert plan.smem_bytes <= H100_SMEM_BLOCK
    B, H = 1, 4
    rows, cols = (width, width) if kind == "wkv6" else \
        (64 if width > 32 else 16, width)
    assert plan.blocks[2] == B * H * plan.segments
    assert plan.blocks[1] == (0 if plan.segments == 1
                              else -(-B * H * rows * cols // 4 // 256))
    state = rows * cols + (rows if kind == "wkv6" else 1)
    cb = 0 if kind == "wkv6" else \
        B * (T // plan.rows) * (-(-plan.rows // 16) * 16) ** 2
    assert plan.workspace_bytes == 4 * (cb + B * H * (plan.segments - 1)
                                        * state)


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_plan_at_full_width_fits_l2_and_fills_a_wave(kind):
    if kind == "wkv6":       # rwkv6-7b: 64 heads of 64, chunk 64
        plan = rwkv6.wkv6_plan(1, 2048, 64, 64, 64, 64, H100_SMS)
    else:                    # zamba2-1.2b: 64 heads of P 64, N 64, chunk 128
        plan = mamba2.ssd_plan(1, 2048, 64, 64, 64, 128, H100_SMS)
    assert plan.workspace_bytes <= L2_BYTES
    assert min(plan.blocks[0], plan.blocks[2]) >= H100_SMS
    assert plan.rows == 64


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        rwkv6.wkv6_plan(1, 100, 2, 64, 64, 64, H100_SMS)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        mamba2.ssd_plan(1, 100, 2, 64, 64, 64, H100_SMS)
    with pytest.raises(ValueError, match="must be equal"):
        rwkv6.wkv6_plan(1, 128, 2, 64, 32, 64, H100_SMS)
    with pytest.raises(ValueError, match="one of"):
        mamba2.ssd_plan(1, 128, 2, 48, 64, 64, H100_SMS)
    with pytest.raises(ValueError, match="do not divide the chunk"):
        rwkv6.wkv6_plan(1, 128, 2, 64, 64, 64, H100_SMS, rows=48)
    with pytest.raises(ValueError, match="do not divide the"):
        mamba2.ssd_plan(1, 128, 2, 64, 64, 64, H100_SMS, rows=32, seg=3)


# ---- the arithmetic, emulated ----

def tf32_head(x):
    """x rounded to TF32 (low 13 bits zero), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """x as the tensor core reads a TF32 operand: low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _toward_zero(x):
    """float64 x rounded to f32 toward zero, as the tensor core rounds
    the sums it accumulates."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


def mma(a, b, split_a=True, split_b=True, acc=None):
    """acc + a @ b as ``repro_ssm::warp_mma``: a (..., M, D), b (..., D,
    N) f32, D a multiple of 16.  Each 16 of depth from zero: per k-step
    of 8 the products lo_a hi_b, hi_a lo_b, hi_a hi_b (a side not split
    is exact in TF32: its products with a tail are skipped), each summed
    exactly and added with rounding toward zero; then added to acc in
    f32."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    for d0 in range(0, a.shape[-1], 16):
        part = torch.zeros_like(out)
        for k0 in (d0, d0 + 8):
            x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
            xh = tf32_head(x) if split_a else x
            yh = tf32_head(y) if split_b else y
            terms = ([(tf32_cut(x - xh), yh)] if split_a else []) \
                + ([(xh, tf32_cut(y - yh))] if split_b else []) + [(xh, yh)]
            for p, q in terms:
                part = _toward_zero(part.double() + p.double() @ q.double())
        out = out + part
    return out


class Exponents:
    """2^x as the kernels take it (x in base 2), recording the largest
    exponent formed."""

    def __init__(self):
        self.most = -float("inf")

    def __call__(self, x):
        self.most = max(self.most, float(x.max()))
        return torch.exp2(x.double()).float()


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _pieces(x, rows, cp):
    """(BH, T, C) -> (BH, pieces, cp, C), each piece padded with zeros."""
    BH, T, C = x.shape
    p = x.reshape(BH, T // rows, rows, C)
    return torch.nn.functional.pad(p, (0, 0, 0, cp - rows))


def _heads(t):
    """(B, T, H, C) -> (B H, T, C) f32."""
    B, T, H, C = t.shape
    return t.float().permute(0, 2, 1, 3).reshape(B * H, T, C)


def _segments(plan, n, update, outputs, shape):
    """The three phases over the plan's segments: (A) each segment but
    the last from zero, its log2 decay the sum of its pieces'; (B) the
    scan; (C) each segment from the state entering it, outputs piece by
    piece, the state carried between them."""
    seg, segments = plan.seg, plan.segments
    states, decays = [], []
    for g in range(segments - 1):
        S, d = torch.zeros(shape), None
        for p in range(seg):
            S, last = update(S, g * seg + p)
            d = last if d is None else d + last
        states.append(S)
        decays.append(d)
    entering, s = [torch.zeros(shape)], torch.zeros(shape)
    for U, d in zip(states, decays):
        s = _fma(torch.exp2(d.double()).float()[..., None]
                 if d.dim() == 2 else torch.exp2(d.double()).float()
                 [..., None, None], s, U)
        entering.append(s)
    outs = []
    for g in range(segments):
        S = entering[g]
        for p in range(seg):
            j = g * seg + p
            outs.append(outputs(S, j, g > 0 or p > 0))
            if p + 1 < seg:
                S = update(S, j)[0]
    return torch.stack(outs, dim=1)


def wkv6_emulated(r, k, v, w, u, plan, ex2):
    """``csrc/wkv6.cu``'s arithmetic: r, k, v (B, T, H, K) f32 or bf16
    values, w (B, T, H, K) and u (H, K) f32; returns (B, T, H, K) f32."""
    B, T, H, K = r.shape
    rows, cp = plan.rows, -(-plan.rows // 16) * 16
    exact_v = r.dtype == torch.bfloat16
    R, Kx, Vx, Wd = (_pieces(_heads(t), rows, cp) for t in (r, k, v, w))
    U = u.float().repeat(B, 1)[:, None, :]                  # (BH, 1, K)
    Wx = []
    for j in range(R.shape[1]):          # W down each column, base 2
        acc, col = torch.zeros(B * H, K), [torch.zeros(B * H, K)]
        for t in range(cp):
            acc = _fma(Wd[:, j, t], LOG2E, acc)
            col.append(acc)
        Wx.append(torch.stack(col, dim=1))                   # (BH, cp+1, K)

    def update(S, j):
        wl = Wx[j][:, cp]
        kd = Kx[:, j] * ex2(wl[:, None, :] - Wx[j][:, 1:])
        return _fma(ex2(wl)[..., None], S,
                    mma(kd.transpose(1, 2), Vx[:, j], True, not exact_v)), wl

    def outputs(S, j, state_in):
        r_, k_, v_, wx = R[:, j], Kx[:, j], Vx[:, j], Wx[j]
        att = torch.zeros(B * H, cp, cp)
        for i in range(1, cp // 16):        # off the diagonal: ref W_{16i-1}
            ref = wx[:, 16 * i][:, None, :]
            a = r_[:, 16 * i:16 * i + 16] * ex2(wx[:, 16 * i:16 * i + 16]
                                                - ref)
            b = k_[:, :16 * i] * ex2(ref - wx[:, 1:16 * i + 1])
            att[:, 16 * i:16 * i + 16, :16 * i] = mma(a, b.transpose(1, 2))
        for i in range(cp // 16):           # the diagonal blocks
            tb = 16 * i
            block = torch.zeros(B * H, 16, 16)
            # across halves and quarters: masked products about the W of
            # the row before (rows, columns)
            for lo, hi, c0, n in ((8, 16, 0, 8), (4, 8, 0, 4),
                                  (12, 16, 8, 4)):
                ref = wx[:, tb + lo][:, None, :]
                a = torch.zeros(B * H, 16, K)
                a[:, lo:hi] = r_[:, tb + lo:tb + hi] * ex2(
                    wx[:, tb + lo:tb + hi] - ref)
                b = torch.zeros(B * H, 8, K)
                b[:, :n] = k_[:, tb + c0:tb + c0 + n] * ex2(
                    ref - wx[:, tb + c0 + 1:tb + c0 + n + 1])
                block[:, lo:hi, c0:c0 + n] = mma(
                    a, b.transpose(1, 2))[:, lo:hi, :n]
            # inside each quarter, on the CUDA cores
            for q in range(4):
                sl = slice(tb + 4 * q, tb + 4 * q + 4)
                e = ex2(torch.minimum(
                    wx[:, sl][:, :, None]
                    - wx[:, tb + 4 * q + 1:tb + 4 * q + 5][:, None],
                    torch.zeros(())))
                pairs = (r_[:, sl][:, :, None] * k_[:, sl][:, None]
                         * e).sum(-1)
                bonus = (r_[:, sl] * (U * k_[:, sl])).sum(-1)
                block[:, 4 * q:4 * q + 4, 4 * q:4 * q + 4] = (
                    torch.tril(pairs, -1) + torch.diag_embed(bonus))
            att[:, tb:tb + 16, tb:tb + 16] = block
        out = torch.zeros(B * H, cp, K)
        for i in range(cp // 16):
            sl = slice(16 * i, 16 * i + 16)
            acc = (mma(r_[:, sl] * ex2(wx[:, sl]), S) if state_in
                   else torch.zeros(B * H, 16, K))
            out[:, sl] = mma(att[:, sl, :16 * i + 16], v_[:, :16 * i + 16],
                             True, not exact_v, acc=acc)
        return out[:, :rows]

    out = _segments(plan, R.shape[1], update, outputs, (B * H, K, K))
    return out.reshape(B, H, T, K).permute(0, 2, 1, 3)


def ssd_emulated(x, dt, A, Bm, Cm, D, plan, ex2):
    """``csrc/ssd.cu``'s arithmetic: x (B, T, H, P), B and C (B, T, N) f32
    or bf16 values, dt (B, T, H), A and D (H,) f32; returns (B, T, H, P)
    f32."""
    Bb, T, H, P = x.shape
    N = Bm.shape[-1]
    rows, cp = plan.rows, -(-plan.rows // 16) * 16
    split = x.dtype != torch.bfloat16
    X = _pieces(_heads(x), rows, cp)
    dts = _pieces(_heads(dt[..., None]), rows, cp)[..., 0]  # (BH, n, cp)
    Bp, Cp = (_pieces(t.float().repeat_interleave(H, 0), rows, cp)
              for t in (Bm, Cm))                         # (B H, n, cp, N)
    Ah = A.float().repeat(Bb)[:, None]
    Dh = D.float().repeat(Bb)[:, None, None]
    CB = [mma(Cp[:, j], Bp[:, j].transpose(1, 2), split, split)
          for j in range(X.shape[1])]
    L = []
    for j in range(X.shape[1]):          # L down the piece, base 2
        acc, col = torch.zeros(Bb * H, 1), []
        for t in range(cp):
            acc = _fma((-Ah) * dts[:, j, t:t + 1], LOG2E, acc)
            col.append(acc)
        L.append(torch.cat(col, dim=1))                      # (BH, cp)

    def update(S, j):
        ll = L[j][:, -1]
        a = Bp[:, j] * (ex2(ll[:, None] - L[j]) * dts[:, j])[..., None]
        return _fma(ex2(ll)[:, None, None], S,
                    mma(a.transpose(1, 2), X[:, j], True, split)), ll

    def outputs(S, j, state_in):
        lj = L[j]
        out = torch.zeros(Bb * H, cp, P)
        for i in range(cp // 16):
            sl = slice(16 * i, 16 * i + 16)
            acc = (mma(Cp[:, j, sl], S, split, True)
                   * ex2(lj[:, sl])[..., None] if state_in
                   else torch.zeros(Bb * H, 16, P))
            t = torch.arange(16 * i, 16 * i + 16)[:, None]
            s = torch.arange(16 * i + 16)[None, :]
            m = torch.where(s <= t, CB[j][:, sl, :16 * i + 16]
                            * ex2(torch.minimum(lj[:, sl, None]
                                                - lj[:, None, :16 * i + 16],
                                                torch.zeros(())))
                            * dts[:, j, None, :16 * i + 16],
                            torch.zeros(()))
            acc = mma(m, X[:, j, :16 * i + 16], True, split, acc=acc)
            out[:, sl] = _fma(Dh, X[:, j, sl], acc)
        return out[:, :rows]

    out = _segments(plan, X.shape[1], update, outputs, (Bb * H, N, P))
    return out.reshape(Bb, H, T, P).permute(0, 2, 1, 3)


def _wkv6_inputs(seed, B, T, H, K, strength="test"):
    """(r, k, v, w, u) as numpy f32, w = -exp(N(0,1) - 2) as the
    reference's test draws it, or a decay extreme."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    z = rng.standard_normal((B, T, H, K))
    w = {"test": -np.exp(z - 2), "strong": -np.exp(z + 2),
         "weak": np.full_like(z, -1e-6)}[strength].astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _ssd_inputs(seed, B, T, H, P, N, strength="test"):
    """(x, dt, A, Bm, Cm, D) as numpy f32: dt = softplus(N(0,1)), A =
    linspace(0.5, 4, H) as the reference's test draws them, or A scaled
    to a decay extreme."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (np.linspace(0.5, 4.0, H) * {"test": 1.0, "strong": 50.0,
                                     "weak": 1e-6}[strength])
    D = rng.standard_normal((H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    return x, dt, A.astype(np.float32), Bm, Cm, D


@pytest.mark.parametrize("B,T,H,K,chunk,rows,seg", [
    (1, 128, 2, 32, 32, None, None),        # the plan: pieces of 32
    (2, 128, 2, 32, 64, 32, 2),             # pieces within a chunk, segments
    (1, 96, 2, 64, 24, None, None),         # 24 rows a piece, padded to 32
])
def test_emulated_wkv6_meets_the_f32_bar(B, T, H, K, chunk, rows, seg):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    arrays = _wkv6_inputs(T + K + chunk, B, T, H, K)
    plan = rwkv6.wkv6_plan(B, T, H, K, K, chunk, H100_SMS, rows=rows,
                           seg=seg)
    ex2 = Exponents()
    out = wkv6_emulated(*(torch.from_numpy(a) for a in arrays), plan, ex2)
    assert torch.isfinite(out).all() and ex2.most <= 0
    ja = [jnp.asarray(a) for a in arrays]
    for impl in ("xla", "interpret") if rows is None else ("xla",):
        expected = jops.wkv6(*ja, impl=impl, chunk=chunk)
        assert _rel(out, expected) < F32_CHUNKED, impl
    assert _rel(out, jref.wkv6_ref(*ja)) < F32_SEQ


@pytest.mark.parametrize("B,T,H,P,N,chunk,rows,seg", [
    (1, 128, 2, 32, 16, 32, None, None),
    (2, 128, 2, 64, 64, 64, 32, 2),
    (1, 96, 3, 32, 16, 48, None, None),     # 48 rows a piece
])
def test_emulated_ssd_meets_the_f32_bar(B, T, H, P, N, chunk, rows, seg):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    arrays = _ssd_inputs(T + P + N, B, T, H, P, N)
    plan = mamba2.ssd_plan(B, T, H, P, N, chunk, H100_SMS, rows=rows,
                           seg=seg)
    ex2 = Exponents()
    out = ssd_emulated(*(torch.from_numpy(a) for a in arrays), plan, ex2)
    assert torch.isfinite(out).all() and ex2.most <= 0
    ja = [jnp.asarray(a) for a in arrays]
    for impl in ("xla", "interpret") if rows is None else ("xla",):
        expected = jops.ssd(*ja, impl=impl, chunk=chunk)
        assert _rel(out, expected) < F32_CHUNKED, impl
    assert _rel(out, jref.ssd_ref(*ja)) < F32_SEQ


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_emulated_bf16_meets_chip_smoke_bars(kind):
    """bf16 operands (the decay path f32), at the plan of a 256-long
    sequence of 4 heads, against the plain version that chip_smoke.py
    holds the kernel to."""
    if kind == "wkv6":
        r, k, v, w, u = (torch.from_numpy(a) for a in
                         _wkv6_inputs(5, 1, 256, 4, 64))
        r, k, v = (t.bfloat16() for t in (r, k, v))
        plan = rwkv6.wkv6_plan(1, 256, 4, 64, 64, 64, H100_SMS, seg=2)
        out = wkv6_emulated(r, k, v, w, u, plan, Exponents())
        ref = rwkv6.wkv6_torch(r, k, v, w, u, chunk=64)
    else:
        x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in
                               _ssd_inputs(6, 1, 256, 4, 64, 64))
        x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
        plan = mamba2.ssd_plan(1, 256, 4, 64, 64, 128, H100_SMS, seg=2)
        out = ssd_emulated(x, dt, A, Bm, Cm, D, plan, Exponents())
        ref = mamba2.ssd_torch(x, dt, A, Bm, Cm, D, chunk=128)
    assert plan.segments > 1
    _bf16_bars(out.bfloat16(), ref)


@pytest.mark.parametrize("strength", ["strong", "weak"])
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_emulated_decay_extremes_stay_finite(kind, strength):
    """A decay that empties the state within a few steps and one that
    keeps it whole: every output finite, every exponent the kernels form
    at most 0, and the f32 bar against the sequential form in float64
    (the plain version's own cumulative sums in f32 are 2.6e-5 off it at
    the strong decay, the emulation 1.7e-6)."""
    ex2 = Exponents()
    if kind == "wkv6":
        arrays = [torch.from_numpy(a)
                  for a in _wkv6_inputs(7, 1, 128, 2, 32, strength)]
        plan = rwkv6.wkv6_plan(1, 128, 2, 32, 32, 64, H100_SMS, seg=2)
        out = wkv6_emulated(*arrays, plan, ex2)
        exact = ssm.wkv6_sequential(*(a.double() for a in arrays))
    else:
        arrays = [torch.from_numpy(a)
                  for a in _ssd_inputs(8, 1, 128, 2, 32, 16, strength)]
        plan = mamba2.ssd_plan(1, 128, 2, 32, 16, 64, H100_SMS, seg=2)
        out = ssd_emulated(*arrays, plan, ex2)
        exact = ssm.ssd_sequential(*(a.double() for a in arrays))[0]
    assert plan.segments > 1
    assert torch.isfinite(out).all() and ex2.most <= 0
    assert _rel(out, exact) < F32_CHUNKED
