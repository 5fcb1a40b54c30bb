"""The bf16 flash-attention kernels for Hopper: dense
(``csrc/flash_attention_sm90.cu``) and paged prefill
(``csrc/paged_prefill_sm90.cu``), one block design
(``csrc/flash_sm90.cuh``).

On the CPU: the tile plan (:func:`flash_attention.sm90_plan`) fits the
232,448 bytes of shared memory a block may opt in to on an H100 for
every registered head dim, mirrors the header's constants, and depends
on the head dim alone (no batch, chunk row or length enters it); every
bf16 entry point comes from its new source and the f32, int8 and fp8
entry points keep theirs; and the plain versions match the JAX package
(``impl="xla"`` and interpret mode) at this file's cuda shapes, at the
reference's bf16 bar (3e-2 of max |ref|).

Marked ``cuda`` (they skip without a card; run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_sm90.py``):
each kernel against its plain version for every registered head dim and
G = 1, 3, 4, 5, 12, with causal, window, ``kv_valid``, ``q_offset`` and
ragged query counts, at the bars of the paged kernels (atol 4e-3 + rtol
1e-2 per element, 1e-2 relative L2 per row); a paged chunk row computed
as one chunk and as two chunks gives the same bits; two calls give the
same bits; one launch is counted per call.
"""

import re
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.build import CSRC, HEAD_DIMS

flash_attention = import_module("repro_torch.kernels.flash_attention")
H100_SMEM = 232448      # shared memory a block may opt in to on an H100
ATOL, RTOL, ROW_TOL = 4e-3, 1e-2, 1e-2
JAX_BF16_TOL = 3e-2     # max |err| / max |ref|, the reference's bf16 bar

#: dense cases (B, H, Hkv, Sq, Skv, D, causal, window, q_offset, kv_valid):
#: every registered head dim; G 3, 1, 4, 5, 1, 12; ragged query tiles
#: (Sq 100, 130, 70), a window, an offset chunk with a short kv_valid,
#: non-causal with Skv off the tile width
DENSE = [
    (2, 6, 2, 100, 100, 16, True, 0, 0, None),
    (1, 4, 4, 130, 130, 32, True, 0, 0, None),
    (1, 8, 2, 192, 192, 64, True, 48, 0, None),
    (2, 10, 2, 64, 256, 80, True, 0, 128, 160),
    (1, 6, 2, 64, 256, 128, True, 40, 64, 200),
    (1, 2, 2, 128, 200, 128, False, 0, 0, None),
    (1, 24, 2, 70, 70, 64, True, 0, 0, None),
]
#: paged cases (G, D, page, window): every registered head dim, G 3, 1,
#: 5, 12, and the page sizes of the cuda tests (4, 8, 16)
PAGED = [
    (3, 128, 16, 0), (3, 128, 16, 40), (1, 64, 8, 0), (5, 128, 4, 0),
    (4, 80, 16, 0), (3, 16, 16, 0), (12, 32, 8, 24),
]
#: the chunk rows of a paged case: a full chunk at offset 0, one at a
#: depth that starts mid-page, a short one, and an inert length-0 row
OFFSET = np.array([0, 48, 131, 0], np.int32)
LENGTH = np.array([100, 71, 9, 0], np.int32)
T, HKV, MAX_LEN = 100, 2, 256


# ---------------------------------------------------------------------------
# CPU: the plan, the sources, the plain versions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_plan_fits_the_shared_memory(head_dim):
    """D pads to whole 64-column boxes; the q tile, 4 stages of a K and
    a V tile and 9 mbarriers fit one block with room to align."""
    plan = flash_attention.sm90_plan(head_dim)
    assert plan.d_pad in (64, 128) and plan.d_pad >= head_dim
    assert plan.d_pad - head_dim < 64
    assert plan.smem_bytes <= H100_SMEM
    assert plan.smem_bytes == (1024 + plan.block_q * plan.d_pad * 2
                               + plan.stages * 2 * plan.block_kv
                               * plan.d_pad * 2 + (2 * plan.stages + 1) * 8)


def test_plan_mirrors_the_header_and_takes_only_the_head_dim():
    """The Python plan is the header's (kBlockQ = 64 * kConsumers,
    kBlockKV, kStages, the 64-column box), and neither it nor the
    kernels' tile template takes anything but the head dim: the batch,
    the chunk rows and the lengths reach the kernels only as the grid
    and the masks, so no launch changes a tile or a row's sums."""
    src = (CSRC / "flash_sm90.cuh").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kConsumers")) * 64 == flash_attention.SM90_BLOCK_Q
    assert int(const("kBlockKV")) == flash_attention.SM90_BLOCK_KV
    assert int(const("kStages")) == flash_attention.SM90_STAGES
    assert int(const("kAtom")) == flash_attention.SM90_ATOM
    assert "template <int D>\nstruct Plan" in src
    for name in ("flash_attention_sm90.cu", "paged_prefill_sm90.cu"):
        kernel_src = (CSRC / name).read_text()
        assert re.findall(r"template <([^>]*)>\n__global__", kernel_src) \
            == ["int D"], name
    assert flash_attention.sm90_plan.__code__.co_argcount == 1


def test_bf16_entry_points_come_from_the_new_sources():
    """Names and registries unchanged; the bf16 instances of kernels 4
    and 2 build from their sm90 sources, the others from theirs."""
    pre, dense = flash_attention.KERNELS, flash_attention.DENSE_KERNELS
    assert pre[torch.bfloat16].source.name == "paged_prefill_sm90.cu"
    assert pre[torch.bfloat16].name == "paged_prefill_attention_bf16"
    assert flash_attention.KERNEL is pre[torch.bfloat16]
    for dt in (torch.int8, torch.float8_e4m3fn):
        assert pre[dt].source.name == "paged_prefill.cu"
    assert dense[torch.bfloat16].source.name == "flash_attention_sm90.cu"
    assert dense[torch.bfloat16].name == "flash_attention_bf16"
    assert dense[torch.float32].source.name == "flash_attention.cu"
    assert dense[torch.float32].name == "flash_attention_f32"
    assert pre[torch.bfloat16] in ops.KERNELS
    assert dense[torch.bfloat16] in ops.DENSE_KERNELS
    for k in (*pre.values(), *dense.values()):
        assert k.source.exists()
    # the old sources no longer export the bf16 instances
    assert "flash_attention_bf16" not in (
        CSRC / "flash_attention.cu").read_text()
    assert "paged_prefill_attention_bf16" not in (
        CSRC / "paged_prefill.cu").read_text()


def _bf16(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _rel_err(out, expected):
    out = np.asarray(out, np.float32)
    expected = np.asarray(expected, np.float32)
    return float(np.abs(out - expected).max()) / max(
        1e-6, float(np.abs(expected).max()))


def _block(n):
    """A block of the JAX kernel that tiles n (it asserts divisibility)."""
    return 64 if n % 64 == 0 else n


@pytest.mark.parametrize(
    "B,H,Hkv,Sq,Skv,D,causal,window,q_offset,kv_valid", DENSE)
def test_dense_plain_matches_jax(B, H, Hkv, Sq, Skv, D, causal, window,
                                 q_offset, kv_valid):
    rng = np.random.default_rng(Sq + Skv + D)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16(rng.standard_normal(s).astype(np.float32))
        for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window)
    out = ops.flash_attention(tq, tk, tv, q_offset=q_offset,
                              kv_valid=kv_valid, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    expected = jops.flash_attention(jq, jk, jv, impl="interpret",
                                    q_offset=q_offset, kv_valid=kv_valid,
                                    bq=_block(Sq), bkv=_block(Skv), **kw)
    assert _rel_err(out.float(), expected) < JAX_BF16_TOL
    if q_offset == 0 and kv_valid is None:   # the XLA path takes neither
        expected = jops.flash_attention(jq, jk, jv, impl="xla", **kw)
        assert _rel_err(out.float(), expected) < JAX_BF16_TOL


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


def _paged_case(groups, head_dim, page, seed):
    """numpy inputs of a paged case: q, the pools, the table."""
    rng = np.random.default_rng(seed)
    table, n_frames = _table(rng, page)
    q = rng.standard_normal((len(OFFSET), T, HKV * groups, head_dim))
    kp, vp = (rng.standard_normal((n_frames, page, HKV, head_dim))
              for _ in range(2))
    return [a.astype(np.float32) for a in (q, kp, vp)] + [table]


@pytest.mark.parametrize("groups,head_dim,page,window", PAGED)
def test_paged_plain_matches_jax(groups, head_dim, page, window):
    q, kp, vp, table = _paged_case(groups, head_dim, page, 7)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(a) for a in (q, kp, vp))
    out = ops.paged_prefill_attention(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(OFFSET),
        torch.from_numpy(LENGTH), window=window)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    for impl in ("xla", "interpret"):
        expected = np.asarray(jops.paged_prefill_attention(
            jq, jk, jv, jnp.asarray(table), jnp.asarray(OFFSET),
            jnp.asarray(LENGTH), window=window, impl=impl), np.float32)
        for c, n in enumerate(LENGTH):
            if n:
                assert _rel_err(out[c, :n].float(), expected[c, :n]) \
                    < JAX_BF16_TOL, (impl, c)


# ---------------------------------------------------------------------------
# cuda: the kernels against their plain versions, bits across splits
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _assert_agree(out, ref):
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    assert torch.all(row <= ROW_TOL), row.max()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,Hkv,Sq,Skv,D,causal,window,q_offset,kv_valid", DENSE)
def test_dense_kernel_matches_plain(dev, B, H, Hkv, Sq, Skv, D, causal,
                                    window, q_offset, kv_valid):
    gen = torch.Generator(device=dev).manual_seed(Sq + D)
    q, k, v = (torch.randn(*s, generator=gen, device=dev).bfloat16()
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid)
    kernel = flash_attention.DENSE_KERNELS[torch.bfloat16]
    before = kernel.launches
    out = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    assert kernel.launches == before + 2
    _assert_agree(out, ops.flash_attention(q, k, v, impl="torch", **kw))
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_dense_kernel_rows_do_not_depend_on_the_launch(dev):
    """A 2048-token prompt at phi4-mini's heads, once whole and once as
    chunks of 256 (q_offset), gives the same bits per row."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(1, 1024, h, 128, generator=gen,
                           device=dev).bfloat16() for h in (24, 8, 8))
    whole = ops.flash_attention(q, k, v)
    _assert_agree(whole, ops.flash_attention(q, k, v, impl="torch"))
    for start in range(0, 1024, 256):
        part = ops.flash_attention(q[:, start:start + 200].contiguous(), k,
                                   v, q_offset=start,
                                   kv_valid=start + 200)
        assert torch.equal(part, whole[:, start:start + 200]), start


def _paged_on(dev, groups, head_dim, page):
    q, kp, vp, table = _paged_case(groups, head_dim, page, 11)
    return ([torch.from_numpy(a).to(dev).bfloat16() for a in (q, kp, vp)]
            + [torch.from_numpy(table).to(dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("groups,head_dim,page,window", PAGED)
def test_paged_kernel_matches_plain(dev, groups, head_dim, page, window):
    q, kp, vp, pt = _paged_on(dev, groups, head_dim, page)
    off = torch.from_numpy(OFFSET).to(dev)
    ln = torch.from_numpy(LENGTH).to(dev)
    kernel = flash_attention.KERNEL
    before = kernel.launches
    out = ops.paged_prefill_attention(q, kp, vp, pt, off, ln, window=window)
    again = ops.paged_prefill_attention(q, kp, vp, pt, off, ln,
                                        window=window)
    assert kernel.launches == before + 2
    ref = ops.paged_prefill_attention(q, kp, vp, pt, off, ln, window=window,
                                      impl="torch")
    for c, n in enumerate(LENGTH):
        _assert_agree(out[c, :n], ref[c, :n])
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,head_dim,page,window", PAGED)
def test_paged_chunk_split_gives_the_same_bits(dev, groups, head_dim, page,
                                               window):
    """Each chunk row computed as one chunk and as two (a cut off the
    tile width, the second chunk beside another row in its launch) gives
    the same bits: what a preempted sequence's re-prefill relies on."""
    q, kp, vp, pt = _paged_on(dev, groups, head_dim, page)
    off = torch.from_numpy(OFFSET).to(dev)
    ln = torch.from_numpy(LENGTH).to(dev)
    whole = ops.paged_prefill_attention(q, kp, vp, pt, off, ln,
                                        window=window)
    for c, n in enumerate(LENGTH):
        if n < 2:
            continue
        cut = int(n) * 3 // 7
        first = ops.paged_prefill_attention(
            q[c:c + 1, :cut].contiguous(), kp, vp, pt[c:c + 1], off[c:c + 1],
            ln.new_tensor([cut]), window=window)
        # the rest, in a launch of two rows: this one and row 0 whole
        rows = torch.stack([pt[c], pt[0]])
        q2 = torch.zeros_like(q[:2])
        q2[0, :n - cut] = q[c, cut:n]
        q2[1] = q[0]
        second = ops.paged_prefill_attention(
            q2, kp, vp, rows, torch.stack([off[c] + cut, off[0]]),
            ln.new_tensor([int(n) - cut, int(LENGTH[0])]), window=window)
        assert torch.equal(first[0], whole[c, :cut]), c
        assert torch.equal(second[0, :n - cut], whole[c, cut:n]), c
        assert torch.equal(second[1, :LENGTH[0]], whole[0, :LENGTH[0]])
