"""Attention blocks, paged and dense: the serving subset of
``repro.models.attention``.

The decode, verify and prefill blocks compute directly on the pool
layout ``(N, page, Hkv, D)`` of one layer: the new tokens' K/V is
scattered into its page-table mapped frames, then attention reads the
pool through the page table — the hand-written CUDA kernels on the
card, their plain PyTorch versions on the CPU (:mod:`repro_torch.kernels.ops`).

In-place pool updates: the JAX package writes ``kp.at[frame, row].set``
into a donated pool; here ``index_put_`` writes into the layer's view of
the pool, so the caller's ``(L, N, page, Hkv, D)`` tensor changes in
place and no block returns a new pool.  Frame ``N - 1`` is the trash
frame: it takes the writes of empty decode slots, of padded chunk tokens,
of verify rows past a slot's draft and of positions past the slot's
capacity.  Only the trash frame ever receives the same (frame, row)
twice in one ``index_put_``, whose order on CUDA is unspecified —
harmless, since the trash frame is never read unmasked.

A quantized pool (int8 / fp8 frames) comes with per-(frame, KV head) f32
scales, handed to each block as ``scales=(k_scales, v_scales)`` of the
layer, (N, Hkv); its scatters are the quantize-and-scatter of
:mod:`repro_torch.kernels.kv_quant` (in place, scales too), and the
attention ops dequantize with the scales.

The dense layout serves the whole-prompt prefill and the non-paged
engine: :func:`attention_block` attends a whole (padded) prompt through
``ops.flash_attention`` (the dense flash attention kernel on the card,
causal, the SWA ``window``; its plain version :func:`chunked_attention`
on the CPU, the reference's dense-prefill arithmetic; not causal for
the encoder, or cross attention to the encoder's output), and
:func:`decode_attention_block` decodes one token against the per-slot
cache of :func:`init_kv_cache` (an SWA ring of ``min(max_len, window)``
slots).  That block keeps the plain :func:`one_token_attention`, as the
reference does: the dense decode kernel (``ops.decode_attention``), like
the TPU kernel it ports, takes one valid length for the whole batch,
and a batch of slots at different depths needs one per row.

The encoder-decoder's decode and prompt chunks attend cached cross K/V
(:func:`cross_block`): one token a slot over every row of its cross
cache through ``ops.decode_attention`` (:func:`cross_decode_attention`:
the dense decode kernel on the card, whose one valid length holds for
the batch, since the reference reads every row), a chunk row over its
slot's first ``src_len`` rows through ``ops.flash_attention``
(:func:`cross_chunk_attention`: a launch a live row, since the kernel
takes one valid length a call).

With ``cfg.mrope_sections`` (qwen2-vl) positions are (3, B, S) t / h / w
ids; the engine carries text, so every block broadcasts its (B, S)
positions to three equal rows, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.build import resolve_impl
from repro_torch.kernels.decode_attention import NEG_INF, one_token_attention
from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.kernels.kv_quant import (KVQuantConfig, quant_scatter_multi,
                                          quant_scatter_token)
from repro_torch.models.layers import dense, mrope, rms_norm, rope

__all__ = ["attention_block", "cross_block", "cross_decode_attention",
           "cross_chunk_attention", "init_kv_cache", "decode_attention_block",
           "init_paged_kv_cache", "paged_decode_attention_block",
           "paged_verify_block", "paged_prefill_block", "one_token_attention",
           "chunked_attention", "NEG_INF"]

Params = Dict[str, torch.Tensor]
Scales = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, compute_dtype):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["q"], x, compute_dtype).reshape(B, S, cfg.num_heads, hd)
    k = dense(p["k"], x, compute_dtype).reshape(B, S, cfg.num_kv_heads, hd)
    v = dense(p["v"], x, compute_dtype).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _position_encode(cfg: ModelConfig, q, k, positions):
    """RoPE, or M-RoPE on (3, B, S) positions when ``cfg.mrope_sections``
    is set."""
    if cfg.mrope_sections:
        return (mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
                mrope(k, positions, cfg.mrope_sections, cfg.rope_theta))
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                     cfg.rope_theta)


def text_positions(cfg: ModelConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    """(B, S) positions as the config's blocks take them: broadcast to
    three equal (t, h, w) rows for M-RoPE, else as they are."""
    if cfg.mrope_sections:
        return positions.expand(3, *positions.shape)
    return positions


def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attention == "swa" else 0


def attention_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    kv: Optional[torch.Tensor] = None, compute_dtype,
                    impl: str = "auto"
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Whole-sequence attention (the dense prefill, the encoder): x (B,
    S, d), positions (B, S) or (3, B, S).  Self-attention, causal or not
    (the encoder), projects q, k and v from x and RoPEs q and k; cross
    attention (``kv`` (B, Skv, d), the encoder's output) projects q from
    x and k, v from ``kv``, with no RoPE and no causal wedge, as the
    reference does.  Attention is ``ops.flash_attention`` with the SWA
    window: on a CUDA tensor the dense flash kernel, or an error; on the
    CPU its plain version.  Returns (out (B, S, d), (k, v)), k / v (B,
    Skv, Hkv, D), for the prefill to cache."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, compute_dtype)
        q, k = _position_encode(cfg, q, k, positions)
    else:
        Skv = kv.shape[1]
        q = dense(p["q"], x, compute_dtype).reshape(B, S, cfg.num_heads, hd)
        k = dense(p["k"], kv, compute_dtype).reshape(B, Skv,
                                                     cfg.num_kv_heads, hd)
        v = dense(p["v"], kv, compute_dtype).reshape(B, Skv,
                                                     cfg.num_kv_heads, hd)
    out = ops.flash_attention(q, k, v, causal=causal and kv is None,
                              window=_window(cfg), impl=impl)
    out = out.reshape(B, S, cfg.num_heads * hd)
    return dense(p["o"], out, compute_dtype), (k, v)


def cross_block(p: Params, cfg: ModelConfig, x: torch.Tensor, attend, *,
                compute_dtype) -> torch.Tensor:
    """Cross attention against cached rows (the enc-dec decode and
    prompt chunk): q projected from the pre-normed ``x`` (B, S, d), no
    RoPE, ``attend(q)`` (B, S, H, D) against the cross K/V that
    :func:`~repro_torch.models.model.encode_cross` projected, projected
    out.  Returns (B, S, d)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["q"], x, compute_dtype).reshape(B, S, cfg.num_heads, hd)
    out = attend(q).reshape(B, S, cfg.num_heads * hd)
    return dense(p["o"], out.to(compute_dtype), compute_dtype)


def cross_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           impl: str = "auto") -> torch.Tensor:
    """One decode token a slot against every row of its cross K/V: q (B,
    1, H, D); k / v (B, Ssrc, Hkv, D), the slots' rows of the layer's
    cross cache.  The reference reads all Ssrc rows unmasked (its
    one-token decode passes no source length), so one valid length,
    Ssrc, holds for the whole batch: on a CUDA tensor the dense decode
    kernel (``ops.decode_attention``, ``valid_len`` = Ssrc), or an
    error; on the CPU the reference's arithmetic, :func:`chunked_
    attention` not causal.  Returns q's shape and dtype."""
    if resolve_impl(impl, q) == "torch":
        zero = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
        return chunked_attention(q, k, v, q_offset=zero, causal=False)
    return ops.decode_attention(q[:, 0], k, v, valid_len=k.shape[1],
                                impl="cuda")[:, None]


def cross_chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rows, *, impl: str = "auto") -> torch.Tensor:
    """A prompt chunk's cross attention, not causal: q (C, T, H, D); k /
    v (B, Ssrc, Hkv, D), the layer's cross cache; ``rows`` one host
    ``(slot, src_len, length)`` a chunk row: row c attends the first
    ``src_len`` rows of its slot's cross K/V.  On the CPU the
    reference's arithmetic: the rows gathered by slot and
    :func:`chunked_attention` with each row's ``kv_valid_len``.  On a
    CUDA tensor the dense flash kernel (``ops.flash_attention``), which
    takes one valid length a call: one launch per live row (``length``
    > 0) on its slot's ``[:src_len]`` rows, which are contiguous; an
    inert row's output is zeros, where the plain version gives an
    average that nothing reads.  Returns q's shape and dtype."""
    if resolve_impl(impl, q) == "torch":
        slots, src_len, _ = (torch.tensor(col, device=q.device)
                             for col in zip(*rows))
        zero = torch.zeros_like(src_len)
        return chunked_attention(q, k[slots], v[slots], q_offset=zero,
                                 causal=False, kv_valid_len=src_len)
    out = torch.zeros_like(q)
    for c, (slot, n, live) in enumerate(rows):
        if live:
            out[c:c + 1] = ops.flash_attention(
                q[c:c + 1], k[slot:slot + 1, :n], v[slot:slot + 1, :n],
                causal=False, impl="cuda")
    return out


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  n_layers: Optional[int] = None,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Stacked-over-layers dense KV cache: ``k``/``v`` (L, batch, slots,
    Hkv, D) zeros, ``pos`` and ``slots`` int32 scalars.  SWA configs get
    a ring of ``slots = min(max_len, window)`` positions (decode writes
    position p at slot p % slots)."""
    L = n_layers if n_layers is not None else cfg.num_layers
    slots = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    shape = (L, batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "slots": torch.tensor(slots, dtype=torch.int32, device=device),
    }


def decode_attention_block(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, 1, d)
    layer_cache: Tuple[torch.Tensor, torch.Tensor],  # k,v (B, slots, Hkv, D)
    pos: torch.Tensor,                   # (B,) int32: per-sequence position
    *,
    compute_dtype,
) -> torch.Tensor:
    """One-token attention against the layer's dense per-slot cache: the
    new token's K/V is written at slot ``pos`` (``pos % slots`` in an
    SWA ring, else clamped to the last slot), in place, then the plain
    :func:`one_token_attention` reads ``min(pos + 1, slots)`` positions
    of each row.  Returns the block output (B, 1, d)."""
    B = x.shape[0]
    kc, vc = layer_cache
    slots = kc.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, compute_dtype)
    q, k_new = _position_encode(cfg, q, k_new,
                                text_positions(cfg, pos[:, None]))
    slot = (pos % slots if cfg.attention == "swa"
            else torch.clamp(pos, max=slots - 1)).long()
    rows = torch.arange(B, device=x.device)
    kc.index_put_((rows, slot), k_new[:, 0].to(kc.dtype))
    vc.index_put_((rows, slot), v_new[:, 0].to(vc.dtype))
    valid = torch.clamp(pos + 1, max=slots)
    out = one_token_attention(q.reshape(B, cfg.num_heads, cfg.head_dim),
                              kc, vc, valid, cfg.num_kv_heads)
    return dense(p["o"], out.to(compute_dtype), compute_dtype)


def init_paged_kv_cache(cfg: ModelConfig, n_frames: int, page_size: int,
                        batch: int, max_len: int, *, device,
                        n_layers: Optional[int] = None,
                        dtype=torch.bfloat16,
                        quant=None) -> Dict[str, torch.Tensor]:
    """KV cache in the device-pool layout: ``k_pages``/``v_pages`` of
    shape (L, n_frames, page, Hkv, D) — one frame holds a page's K or V
    for every layer — and the per-slot ``page_table`` (batch,
    pages_per_seq) int32, initialised to the trash frame ``n_frames - 1``.
    The per-sequence capacity must be a multiple of ``page_size``.

    ``quant`` (a :class:`KVQuantConfig` or mode name) makes the frames
    int8 / fp8 and adds ``k_scales``/``v_scales`` (L, n_frames, Hkv) f32,
    zeros; the keys are absent in ``none`` mode, so the bf16 cache is the
    same dict as without quantization."""
    L = n_layers if n_layers is not None else cfg.num_layers
    slots = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    if slots % page_size:
        raise ValueError(
            f"page_size {page_size} must divide the per-sequence token "
            f"capacity {slots} for the paged decode layout")
    quant = KVQuantConfig.from_name(quant)
    if quant.enabled:
        dtype = quant.dtype
    shape = (L, n_frames, page_size, cfg.num_kv_heads, cfg.head_dim)
    out = {
        "k_pages": torch.zeros(shape, dtype=dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=dtype, device=device),
        "page_table": torch.full((batch, slots // page_size), n_frames - 1,
                                 dtype=torch.int32, device=device),
    }
    if quant.enabled:
        sshape = (L, n_frames, cfg.num_kv_heads)
        out["k_scales"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
        out["v_scales"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
    return out


def _scatter(kp, vp, scales: Scales, k_new, v_new, frame, row,
             window=None) -> None:
    """Write K/V into the layer's pool at (frame, row), in place; into a
    quantized pool through the quantize-and-scatter: one token per slot
    (decode), or, with ``window = (page_rows, page_idx, ok)``, a window of
    tokens per row (prefill chunk, verify rows)."""
    if scales is None:
        kp.index_put_((frame, row), k_new.to(kp.dtype))
        vp.index_put_((frame, row), v_new.to(vp.dtype))
        return
    qcfg = KVQuantConfig.from_dtype(kp.dtype)
    for pages, sc, new in ((kp, scales[0], k_new), (vp, scales[1], v_new)):
        if window is None:
            quant_scatter_token(pages, sc, new, frame, row, qcfg)
        else:
            page_rows, page_idx, ok = window
            quant_scatter_multi(pages, sc, new, page_rows, page_idx, row, ok,
                                frame, qcfg)


def _scale_kw(scales: Scales) -> Dict[str, torch.Tensor]:
    return {} if scales is None else {"k_scales": scales[0],
                                      "v_scales": scales[1]}


def paged_decode_attention_block(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, 1, d)
    layer_pages: Tuple[torch.Tensor, torch.Tensor],  # k,v (N, page, Hkv, D)
    page_table: torch.Tensor,            # (B, pages_per_seq) int32 frame ids
    pos: torch.Tensor,                   # (B,) int32: per-sequence position
    *,
    compute_dtype,
    impl: str = "auto",
    scales: Scales = None,               # (k, v) scales (N, Hkv), quantized
) -> torch.Tensor:
    """One-token attention on the paged layout: scatter the new token's
    K/V into its mapped frame (in place), attend through the page table,
    project out.  Returns the block output (B, 1, d)."""
    B = x.shape[0]
    kp, vp = layer_pages
    page = kp.shape[1]
    slots = page_table.shape[1] * page           # token capacity per sequence
    q, k_new, v_new = _project_qkv(p, cfg, x, compute_dtype)
    q, k_new = _position_encode(cfg, q, k_new,
                                text_positions(cfg, pos[:, None]))
    slot = (pos % slots if cfg.attention == "swa"
            else torch.clamp(pos, max=slots - 1)).long()
    frame = page_table[torch.arange(B, device=x.device), slot // page].long()
    row = slot % page
    _scatter(kp, vp, scales, k_new[:, 0], v_new[:, 0], frame, row)
    valid = torch.clamp(pos + 1, max=slots)       # (B,) int32
    out = ops.paged_decode_attention(q[:, 0], kp, vp, page_table, valid,
                                     impl=impl, **_scale_kw(scales))
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim).to(compute_dtype)
    return dense(p["o"], out, compute_dtype)


def paged_verify_block(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, S, d)
    layer_pages: Tuple[torch.Tensor, torch.Tensor],  # k,v (N, page, Hkv, D)
    page_table: torch.Tensor,            # (B, pages_per_seq) int32 frame ids
    pos: torch.Tensor,                   # (B,) int32: position of x[:, 0]
    length: torch.Tensor,                # (B,) int32 valid rows (0 = inert)
    *,
    compute_dtype,
    impl: str = "auto",
    scales: Scales = None,
) -> torch.Tensor:
    """Verify-K attention for self-speculative decode on the paged pool:
    :func:`paged_decode_attention_block` with ``S = K + 1`` query rows per
    slot (row 0 the last committed token, rows 1..K the drafts).

    Row ``s`` of slot ``b`` lands at position ``pos[b] + s``, RoPE'd
    there; rows at/past ``length`` (and positions past the slot's
    capacity) scatter to the trash frame, so a capped draft or an empty
    slot never dirties a real frame.  Attention reads the pool with a
    per-row valid length ``min(pos + s + 1, slots)``: row ``s`` sees
    itself and every draft row before it, the view the s-th sequential
    decode step would have.  No SWA ring semantics (speculation is gated
    off for SWA).  Returns (B, S, d)."""
    B, S, _ = x.shape
    kp, vp = layer_pages
    page = kp.shape[1]
    pages_per_seq = page_table.shape[1]
    slots = pages_per_seq * page
    trash = kp.shape[0] - 1
    q, k_new, v_new = _project_qkv(p, cfg, x, compute_dtype)
    s_idx = torch.arange(S, dtype=torch.int32, device=x.device)
    abs_pos = pos[:, None] + s_idx[None, :]                  # (B, S)
    q, k_new = _position_encode(cfg, q, k_new,
                                text_positions(cfg, abs_pos))

    ok = (s_idx[None, :] < length[:, None]) & (abs_pos < slots)
    page_idx = torch.clamp(abs_pos // page, 0, pages_per_seq - 1)
    frame = torch.where(ok, torch.gather(page_table, 1, page_idx.long()),
                        trash).long()
    row = (abs_pos % page).long()
    _scatter(kp, vp, scales, k_new, v_new, frame, row,
             (page_table, page_idx, ok))
    valid = torch.clamp(abs_pos + 1, max=slots)              # (B, S)

    out = ops.paged_verify_attention(q, kp, vp, page_table, valid, impl=impl,
                                     **_scale_kw(scales))
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim).to(compute_dtype)
    return dense(p["o"], out, compute_dtype)


def paged_prefill_block(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (C, T, d) pre-normed chunk hidden
    layer_pages: Tuple[torch.Tensor, torch.Tensor],  # k,v (N, page, Hkv, D)
    page_rows: torch.Tensor,             # (C, pages_per_seq) int32 frame ids
    offset: torch.Tensor,                # (C,) absolute position of x[:, 0]
    length: torch.Tensor,                # (C,) valid tokens in this chunk
    positions: torch.Tensor,             # (C, T) or (3, C, T) positions
    *,
    compute_dtype,
    impl: str = "auto",
    scales: Scales = None,
) -> torch.Tensor:
    """One prompt chunk per row on the paged layout: scatter the chunk's
    K/V into its mapped frames (in place; padding and out-of-capacity
    tokens go to the trash frame), flash-attend the row's pool-resident
    prefix plus the chunk with the causal wedge shifted by ``offset``,
    project out.  Returns (C, T, d); rows at/past ``length`` are
    don't-care."""
    C, T, _ = x.shape
    kp, vp = layer_pages
    page = kp.shape[1]
    pages_per_seq = page_rows.shape[1]
    slots = pages_per_seq * page
    trash = kp.shape[0] - 1
    q, k_new, v_new = _project_qkv(p, cfg, x, compute_dtype)
    q, k_new = _position_encode(cfg, q, k_new, positions)

    t = torch.arange(T, dtype=torch.int32, device=x.device)
    abs_pos = offset[:, None] + t[None, :]                   # (C, T)
    ok = (t[None, :] < length[:, None]) & (abs_pos < slots)
    page_idx = torch.clamp(abs_pos // page, 0, pages_per_seq - 1)
    frame = torch.where(ok, torch.gather(page_rows, 1, page_idx.long()),
                        trash).long()
    row = (abs_pos % page).long()
    _scatter(kp, vp, scales, k_new, v_new, frame, row,
             (page_rows, page_idx, ok))

    out = ops.paged_prefill_attention(
        q, kp, vp, page_rows, offset, length,
        window=_window(cfg), impl=impl, **_scale_kw(scales))
    out = out.reshape(C, T, cfg.num_heads * cfg.head_dim).to(compute_dtype)
    return dense(p["o"], out, compute_dtype)
