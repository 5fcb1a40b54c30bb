"""The paged decode and verify kernels' split over KV ranges.

On the CPU: the properties of the range rule
(``decode_attention.paged_split_positions``), of the ranges it cuts
(``paged_split_ranges``) and of the wrappers' cut (``paged_split_plan``):
the ranges cover [0, capacity) once, on multiples of 64; a decode call
and a verify call of one (B, Hkv, G, capacity) cut alike whatever S is;
the phase-2 and engine shapes of ``chip_smoke.py`` reach at least two
live blocks per SM on an H100's 132.  Then an f32 emulation in plain
torch of what the kernels compute — positions mapped one by one through
the page table, 64-position tiles with the online softmax inside a
range, each row masked by its own length, a row's ranges below its
length merged in order by the log-sum-exp rule of ``csrc/split_kv.cuh``,
the others never read, nothing read past the longest row — held against
the JAX ``paged_decode_attention`` / ``paged_verify_attention`` in
interpret mode at the reference's bars: 1e-5 for f32 and bf16 pools,
2e-5 for int8/fp8 pools (the dequantized view, as
``tests/test_torch_quant.py`` holds the plain versions), for every range
length, with empty ranges and rows of length 0.

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_paged_split.py``):
every pool type x head dim x G in {1, 3, 5, 12} x range length (one
range, one tile each, the default), decode and verify against their
plain versions at phase 2's bars (atol 4e-3 + rtol 1e-2 per element,
1e-2 relative L2 per row); verify row s bitwise the decode kernel at
``lengths[:, s]`` at every range length; length 0 stores zeros; two
calls give the same bits; one launch counted per call; a NaN scale on
the trash frame changes no bit.
"""

import math
from importlib import import_module

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import HEAD_DIMS
from repro_torch.kernels.kv_quant import KVQuantConfig, quantize

dec = import_module("repro_torch.kernels.decode_attention")

H100_SMS = 132
TILE = 64
#: (B, Hkv, G, capacity, lengths) of chip_smoke.py's phase-2 decode and
#: verify (the verify rows' longest), its phase-2d G5 / G12 / D80 cases
#: (the same lengths), and the engine's: phi4-mini (24/8 heads) and
#: olmoe (16/16) with 8 rows of chip_smoke's prompts (512-1536 tokens)
_P2_DECODE = [1, 16, 17, 255, 640, 1000, 1537, 2048]
_P2_VERIFY = [5, 16, 20, 259, 644, 1004, 1541, 2048]
SHAPES = [
    ("phase 2 decode", 8, 8, 3, 2048, _P2_DECODE),
    ("phase 2 verify", 8, 8, 3, 2048, _P2_VERIFY),
    ("phase 2d G5", 8, 8, 5, 2048, _P2_DECODE),
    ("phase 2d G12", 8, 8, 12, 2048, _P2_DECODE),
    ("phase 2d D80", 8, 8, 4, 2048, _P2_DECODE),
]
ENGINE_SHAPES = [("phi4-mini-3.8b", 8, 8, 3), ("olmoe-1b-7b", 8, 16, 1)]


def _live_blocks(B, Hkv, G, capacity, lengths, span):
    """Blocks of a decode grid that read K/V: a sequence's ranges below
    its length, per KV head and block of query heads."""
    heads = dec._head_blocks(G)
    return Hkv * heads * sum(-(-min(n, capacity) // span) for n in lengths)


@pytest.mark.parametrize("B,Hkv,G", [(1, 1, 1), (2, 2, 3), (8, 8, 3),
                                     (8, 16, 1), (8, 8, 12), (64, 8, 5),
                                     (4, 1, 40)])
@pytest.mark.parametrize("capacity", [16, 64, 100, 192, 2048, 4096, 32768])
def test_ranges_cover_the_table_once(B, Hkv, G, capacity):
    span = dec.paged_split_positions(B, Hkv, G, capacity, H100_SMS)
    assert span % TILE == 0 and span >= TILE
    assert span == dec.paged_split_positions(B, Hkv, G, capacity, H100_SMS)
    assert span <= -(-capacity // TILE) * TILE      # no range past it all
    ranges = dec.paged_split_ranges(capacity, span)
    assert ranges[0][0] == 0 and ranges[-1][1] == capacity
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1                              # contiguous, once
    for s, e in ranges:
        assert s % TILE == 0 and s < e
    for s, e in ranges[:-1]:
        assert e - s == span
    assert len(ranges) == -(-capacity // span)


@pytest.mark.parametrize("capacity,span", [(192, 64), (192, 128),
                                           (192, 192), (192, 256),
                                           (2048, 448), (100, 64)])
def test_forced_ranges(capacity, span):
    ranges = dec.paged_split_ranges(capacity, span)
    assert sum(e - s for s, e in ranges) == capacity
    assert all(s % TILE == 0 for s, _ in ranges)
    assert len(ranges) == -(-capacity // span)


@pytest.mark.parametrize("B,Hkv,G,pps,page", [(8, 8, 3, 128, 16),
                                              (8, 16, 1, 128, 16),
                                              (3, 2, 5, 16, 4),
                                              (6, 2, 12, 32, 16),
                                              (1, 4, 1, 3, 8)])
def test_decode_and_verify_cut_alike_whatever_s(B, Hkv, G, pps, page):
    """The wrappers' cut (``paged_split_plan``, what ``_launch`` runs) of a
    decode call and of verify calls with S = 1..8 rows: the same range
    length and count, a workspace of B * S * H * ranges * (D + 2) f32
    when there is more than one range, none otherwise."""
    H, D = Hkv * G, 64
    pool = (B * pps + 1, page, Hkv, D)
    span, n, ws = dec.paged_split_plan((B, H, D), pool, pps, H100_SMS)
    assert span == dec.paged_split_positions(B, Hkv, G, pps * page,
                                             H100_SMS)
    assert n == -(-pps * page // span)
    assert ws == (B * H * n * (D + 2) if n > 1 else 0)
    for S in range(1, 9):
        vspan, vn, vws = dec.paged_split_plan((B, S, H, D), pool, pps,
                                              H100_SMS)
        assert (vspan, vn) == (span, n), S
        assert vws == S * ws
    for forced in (64, 128, -(-pps * page // TILE) * TILE + TILE):
        assert dec.paged_split_plan((B, H, D), pool, pps, H100_SMS,
                                    forced)[:2] == \
            dec.paged_split_plan((B, 5, H, D), pool, pps, H100_SMS,
                                 forced)[:2]
    for bad in (0, 32, 100, -64):
        with pytest.raises(ValueError, match="split_positions"):
            dec.paged_split_plan((B, H, D), pool, pps, H100_SMS, bad)


@pytest.mark.parametrize("what,B,Hkv,G,capacity,lengths", SHAPES)
def test_phase_2_shapes_fill_the_card(what, B, Hkv, G, capacity, lengths):
    """At least two blocks an SM read K/V at phase 2's ragged lengths
    (5514 positions of 8 x 2048), where the unsplit kernel ran 64."""
    span = dec.paged_split_positions(B, Hkv, G, capacity, H100_SMS)
    live = _live_blocks(B, Hkv, G, capacity, lengths, span)
    assert live >= 2 * H100_SMS, (what, span, live)


@pytest.mark.parametrize("arch,B,Hkv,G", ENGINE_SHAPES)
def test_engine_shapes_fill_the_card(arch, B, Hkv, G):
    """The engine's decode steps (``chip_smoke.py``'s settings: 8 rows,
    2048-position tables) at the lengths of the first 8 prompts it
    admits: at least two live blocks an SM, at the rule's range lengths
    (192 and 384, which ``tools/paged_split_sweep.py`` settled)."""
    import chip_smoke

    capacity = chip_smoke.ENGINE["max_len"]
    lengths = [len(p) for p in chip_smoke.prompts(50304)][:B]
    span = dec.paged_split_positions(B, Hkv, G, capacity, H100_SMS)
    assert span == {"phi4-mini-3.8b": 192, "olmoe-1b-7b": 384}[arch]
    assert _live_blocks(B, Hkv, G, capacity, lengths, span) \
        >= 2 * H100_SMS, (arch, span)


# ---- the split-and-combine, emulated in f32 ----

def split_combine(q, k_pages, v_pages, page_table, lengths, span,
                  k_scales=None, v_scales=None):
    """What the kernels compute, in f32 plain torch: q (B, S, H, D),
    lengths (B, S) -> (B, S, H, D) in q's dtype.  Position p of row b is
    pool row p % page of frame page_table[b, min(p // page, pps - 1)],
    dequantized by that frame's scale; rows at or past the sequence's
    longest length are zeros, never read into the sums."""
    B, S, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    capacity = pps * page
    G = H // Hkv
    qf = q.float().reshape(B, S, Hkv, G, D) * (1.0 / math.sqrt(D))
    lens = lengths.long().clamp(0, capacity)                  # (B, S)
    longest = lens.amax(1)                                    # (B,)

    def rows(pool, scales, pos):
        frame = page_table[:, (pos // page).clamp(max=pps - 1)].long()
        x = pool[frame, (pos % page)[None, :]].float()        # (B, T, Hkv, D)
        if scales is not None:
            x = x * scales[frame][..., None]
        return torch.where((pos[None, :] < longest[:, None])[..., None, None],
                           x, torch.zeros(()))

    ms, ls, accs = [], [], []
    for r0, r1 in dec.paged_split_ranges(capacity, span):
        m = torch.full((B, S, Hkv, G, 1), dec.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, S, Hkv, G, D)
        for t0 in range(r0, r1, TILE):
            pos = torch.arange(t0, min(t0 + TILE, r1))
            kt, vt = rows(k_pages, k_scales, pos), rows(v_pages, v_scales, pos)
            live = (pos[None, None, :] < lens[:, :, None])[:, :, None, None]
            s = torch.where(live, torch.einsum("bshgd,bthd->bshgt", qf, kt),
                            torch.tensor(dec.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(live, torch.exp(s - m_new), torch.zeros(()))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bshgt,bthd->bshgd", p, vt)
            m = m_new
        ms.append(m), ls.append(l), accs.append(acc)
    # a row merges its first ceil(len / span) ranges; the others are
    # never read
    n_live = -(-lens // span)                                 # (B, S)
    use = [(j < n_live)[:, :, None, None, None] for j in range(len(ms))]
    big = torch.stack([torch.where(u, m, torch.tensor(dec.NEG_INF))
                       for u, m in zip(use, ms)]).amax(0)
    den, num = torch.zeros_like(big), torch.zeros_like(accs[0])
    for u, m, l, acc in zip(use, ms, ls, accs):
        w = torch.where(u, torch.exp(m - big), torch.zeros(()))
        den = den + torch.where(u, l, torch.zeros(())) * w
        num = num + torch.where(u, acc, torch.zeros(())) * w
    return (num / den.clamp_min(1e-30)).reshape(B, S, H, D).to(q.dtype)


N_FRAMES, PAGE, HKV, D, H, PPS = 160, 4, 2, 16, 6, 48   # G = 3, cap 192
CAPACITY = PAGE * PPS
LENGTHS = np.array([0, 1, 5, 64, 65, 130, 192], np.int32)
SPANS = (64, 128, 192, 256)                   # 3, 2, 1, 1 ranges
POOLS = ("float32", "bfloat16", "int8", "fp8")
TOLS = {"float32": 1e-5, "bfloat16": 1e-5, "int8": 2e-5, "fp8": 2e-5}


def _table(rng, longest):
    """Disjoint random frames for each row's pages, the rest of the table
    on the trash frame N_FRAMES - 1."""
    table = np.full((len(longest), PPS), N_FRAMES - 1, np.int32)
    perm, at = rng.permutation(N_FRAMES - 1), 0
    for b, n in enumerate(longest):
        used = -(-int(n) // PAGE)
        table[b, :used] = perm[at:at + used]
        at += used
    return table


def _pools(rng, kind):
    """(JAX k, JAX v, torch k, torch v, JAX scale kw, torch scale kw) with
    the same values: f32, bf16 (rounded once), or int8/fp8 frames with
    absmax scales per (frame, KV head)."""
    import jax.numpy as jnp
    from repro.kernels import kv_quant as jq

    made = []
    for _ in range(2):
        x = rng.standard_normal((N_FRAMES, PAGE, HKV, D)).astype(np.float32)
        if kind in ("float32", "bfloat16"):
            j = jnp.asarray(x, getattr(jnp, kind))
            made.append((j, torch.from_numpy(np.asarray(j.astype(jnp.float32)))
                         .to(getattr(torch, kind)), None))
            continue
        qc = jq.KVQuantConfig(kind)
        s = (np.abs(x).max(axis=(1, 3)) / np.float32(qc.qmax)) \
            .astype(np.float32)
        j = jq.quantize(jnp.asarray(x), jnp.asarray(s)[:, None, :, None], qc)
        raw = np.asarray(j).view(np.uint8).copy()
        t = torch.from_numpy(raw).view(KVQuantConfig(kind).dtype)
        made.append((j, t, s))
    (jk, tk, ks), (jv, tv, vs) = made
    if ks is None:
        return jk, jv, tk, tv, {}, {}
    return (jk, jv, tk, tv, {"k_scales": jnp.asarray(ks),
                             "v_scales": jnp.asarray(vs)},
            {"k_scales": torch.from_numpy(ks),
             "v_scales": torch.from_numpy(vs)})


@pytest.mark.parametrize("kind", POOLS)
def test_split_combine_matches_jax_decode(kind):
    """Decode rows of length 0, 1, 5, 64, 65, 130 and the whole 192-long
    table, against the JAX kernel in interpret mode, at every range length:
    three ranges of one tile, two, one; a length-0 row gives zeros."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    rng = np.random.default_rng(11)
    pt = _table(rng, LENGTHS)
    jk, jv, tk, tv, jkw, tkw = _pools(rng, kind)
    q = rng.standard_normal((len(LENGTHS), H, D)).astype(np.float32)
    ref = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(LENGTHS),
        impl="interpret", **jkw))
    tq, tpt = torch.from_numpy(q), torch.from_numpy(pt)
    tl = torch.from_numpy(LENGTHS)
    for span in SPANS + (dec.paged_split_positions(
            len(LENGTHS), HKV, H // HKV, CAPACITY, H100_SMS),):
        out = split_combine(tq[:, None], tk, tv, tpt, tl[:, None], span,
                            **tkw)[:, 0].numpy()
        assert np.isfinite(out).all()
        assert not out[0].any()                       # length 0: zeros
        np.testing.assert_allclose(out[1:], ref[1:], atol=TOLS[kind],
                                   rtol=TOLS[kind], err_msg=str(span))


@pytest.mark.parametrize("kind", POOLS)
def test_split_combine_matches_jax_verify(kind):
    """Verify rows s = 0..2 of lengths base + s (a row of length 0 first,
    rows that end in different ranges of one sequence), against the JAX
    kernel in interpret mode at every range length; row s equals the
    decode emulation at ``lengths[:, s]``."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    S = 3
    lengths = np.minimum(np.array([0, 1, 62, 63, 127, 128, 190])[:, None]
                         + np.arange(S)[None, :], CAPACITY).astype(np.int32)
    rng = np.random.default_rng(12)
    pt = _table(rng, lengths.max(1))
    jk, jv, tk, tv, jkw, tkw = _pools(rng, kind)
    q = rng.standard_normal((len(lengths), S, H, D)).astype(np.float32)
    ref = np.asarray(jops.paged_verify_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lengths),
        impl="interpret", **jkw))
    tq, tpt = torch.from_numpy(q), torch.from_numpy(pt)
    tl = torch.from_numpy(lengths)
    live = lengths > 0
    for span in SPANS:
        out = split_combine(tq, tk, tv, tpt, tl, span, **tkw)
        assert torch.isfinite(out).all()
        assert not out[torch.from_numpy(~live)].any()   # length 0: zeros
        np.testing.assert_allclose(out.numpy()[live], ref[live],
                                   atol=TOLS[kind], rtol=TOLS[kind],
                                   err_msg=str(span))
        for s in range(S):
            one = split_combine(tq[:, s:s + 1], tk, tv, tpt, tl[:, s:s + 1],
                                span, **tkw)
            torch.testing.assert_close(out[:, s], one[:, 0], atol=1e-6,
                                       rtol=1e-6)


def test_split_combine_never_reads_the_trash_frame():
    """A NaN scale and NaN rows on the trash frame (every table entry past
    a row's pages) change nothing: no position at or past the longest
    row is dequantized or summed."""
    rng = np.random.default_rng(13)
    pt = torch.from_numpy(_table(rng, LENGTHS))
    _, _, tk, tv, _, tkw = _pools(rng, "int8")
    q = torch.from_numpy(rng.standard_normal(
        (len(LENGTHS), 1, H, D)).astype(np.float32))
    tl = torch.from_numpy(LENGTHS)[:, None]
    clean = split_combine(q, tk, tv, pt, tl, 64, **tkw)
    junk = {k: v.clone() for k, v in tkw.items()}
    for v in junk.values():
        v[N_FRAMES - 1] = float("nan")
    assert torch.equal(split_combine(q, tk, tv, pt, tl, 64, **junk), clean)


# ---- on the card ----

ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2
CARD_PAGE, CARD_PPS, CARD_HKV = 16, 32, 2              # capacity 512
CARD_LENGTHS = (0, 1, 63, 64, 65, 300, 511, 512)
CARD_MODES = ("none", "int8", "fp8")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _agree(out, ref, what):
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all(), what
    torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL, msg=str(what))
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert torch.all(row <= ROW_TOL), (what, float(row.max()))


def _card_pools(n_frames, head_dim, mode, gen, dev):
    """bf16 pools, or int8/fp8 frames quantized from normal draws with
    absmax scales per (frame, KV head); returns (k, v, scale keywords)."""
    if mode == "none":
        return (*(torch.randn(n_frames, CARD_PAGE, CARD_HKV, head_dim,
                              generator=gen, device=dev).bfloat16()
                  for _ in range(2)), {})
    qcfg = KVQuantConfig(mode)
    made = []
    for _ in range(2):
        x = torch.randn(n_frames, CARD_PAGE, CARD_HKV, head_dim,
                        generator=gen, device=dev)
        s = x.abs().amax(dim=(1, 3)) * qcfg.inv_qmax
        made += [quantize(x, s[:, None, :, None], qcfg), s.contiguous()]
    return made[0], made[2], {"k_scales": made[1], "v_scales": made[3]}


def _card_table(longest, n_frames, gen, dev):
    table = torch.full((len(longest), CARD_PPS), n_frames - 1,
                       dtype=torch.int32)
    perm, at = torch.randperm(n_frames - 1, generator=torch.Generator()
                              .manual_seed(len(longest))), 0
    for b, n in enumerate(longest):
        used = -(-n // CARD_PAGE)
        table[b, :used] = perm[at:at + used].int()
        at += used
    return table.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CARD_MODES)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("groups", [1, 3, 5, 12])
def test_kernels_match_plain_at_every_range(dev, mode, head_dim, groups):
    B, S = len(CARD_LENGTHS), 5
    gen = torch.Generator(device=dev).manual_seed(head_dim * 31 + groups)
    n_frames = B * CARD_PPS + 1
    lengths = torch.tensor([[max(0, min(n - S + 1 + s, 512)) if n else 0
                             for s in range(S)] for n in CARD_LENGTHS],
                           dtype=torch.int32, device=dev)
    pt = _card_table([int(n) for n in lengths.max(1).values], n_frames,
                     gen, dev)
    kp, vp, kw = _card_pools(n_frames, head_dim, mode, gen, dev)
    H = CARD_HKV * groups
    q = torch.randn(B, S, H, head_dim, generator=gen,
                    device=dev).bfloat16()
    dt = kp.dtype
    dk, vk = dec.KERNELS[dt], dec.VERIFY_KERNELS[dt]
    live = lengths > 0
    ref_v = ops.paged_verify_attention(q, kp, vp, pt, lengths, impl="torch",
                                       **kw)
    ref_d = [ops.paged_decode_attention(q[:, s].contiguous(), kp, vp, pt,
                                        lengths[:, s].contiguous(),
                                        impl="torch", **kw)
             for s in range(S)]
    for span in (CARD_PAGE * CARD_PPS, TILE, None):
        what = (mode, head_dim, groups, span)
        before = (dk.launches, vk.launches)
        out = dec.paged_verify_attention_cuda(q, kp, vp, pt, lengths, **kw,
                                              split_positions=span)
        assert (dk.launches, vk.launches) == (before[0], before[1] + 1)
        _agree(out[live], ref_v[live], what)
        assert not out[~live].float().any(), what      # length 0: zeros
        again = dec.paged_verify_attention_cuda(q, kp, vp, pt, lengths,
                                                **kw, split_positions=span)
        assert torch.equal(out, again), what
        for s in range(S):
            args = (q[:, s].contiguous(), kp, vp, pt,
                    lengths[:, s].contiguous())
            n = dk.launches
            one = dec.paged_decode_attention_cuda(*args, **kw,
                                                  split_positions=span)
            assert dk.launches == n + 1
            assert torch.equal(out[:, s], one), (what, s)
            rows = live[:, s]
            _agree(one[rows], ref_d[s][rows], (what, s))
            assert not one[~rows].float().any(), (what, s)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CARD_MODES)
def test_junk_on_the_trash_frame_moves_no_bit(dev, mode):
    """NaN in the trash frame's rows and scales (every table entry past a
    row's pages points there): decode and verify give the same bits as
    with finite junk, at every range length."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, head_dim = len(CARD_LENGTHS), 3, 128
    n_frames = B * CARD_PPS + 1
    lengths = torch.tensor([[max(0, n - S + 1 + s) if n else 0
                             for s in range(S)] for n in CARD_LENGTHS],
                           dtype=torch.int32, device=dev)
    pt = _card_table([int(n) for n in lengths.max(1).values], n_frames,
                     gen, dev)
    kp, vp, kw = _card_pools(n_frames, head_dim, mode, gen, dev)
    q = torch.randn(B, S, CARD_HKV * 3, head_dim, generator=gen,
                    device=dev).bfloat16()
    jk, jv = kp.clone(), vp.clone()
    jkw = {k: v.clone() for k, v in kw.items()}
    if mode == "none":
        jk[-1], jv[-1] = float("nan"), float("nan")
    else:
        for v in jkw.values():
            v[-1] = float("nan")
    for span in (TILE, 192, None):
        a = dec.paged_verify_attention_cuda(q, kp, vp, pt, lengths, **kw,
                                            split_positions=span)
        b = dec.paged_verify_attention_cuda(q, jk, jv, pt, lengths, **jkw,
                                            split_positions=span)
        assert torch.isfinite(b.float()).all() and torch.equal(a, b), span
        d = dec.paged_decode_attention_cuda(
            q[:, 0].contiguous(), jk, jv, pt, lengths[:, 0].contiguous(),
            **jkw, split_positions=span)
        assert torch.equal(a[:, 0], d), span


@pytest.mark.cuda
def test_phase_2_decode_through_ops(dev):
    """Phase 2's decode case (8 rows, 24/8 heads of 128, lengths 1..2048,
    page 16) through ``ops`` with the default range length: one launch,
    the plain version's output, the same bits as the forced default."""
    gen = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.tensor(_P2_DECODE, dtype=torch.int32, device=dev)
    pps, page = 128, 16
    n_frames = 8 * pps + 1
    table = torch.arange(8 * pps, dtype=torch.int32, device=dev) \
        .reshape(8, pps)
    kp, vp = (torch.randn(n_frames, page, 8, 128, generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    q = torch.randn(8, 24, 128, generator=gen, device=dev).bfloat16()
    kernel = dec.KERNELS[torch.bfloat16]
    before = kernel.launches
    out = ops.paged_decode_attention(q, kp, vp, table, lengths)
    assert kernel.launches == before + 1
    _agree(out, ops.paged_decode_attention(q, kp, vp, table, lengths,
                                           impl="torch"), "phase 2")
    span = dec.paged_split_positions(8, 8, 3, pps * page,
                                     dec.sm_count(dev))
    assert torch.equal(out, dec.paged_decode_attention_cuda(
        q, kp, vp, table, lengths, split_positions=span))
