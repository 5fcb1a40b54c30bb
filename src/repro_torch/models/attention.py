"""Attention blocks on the paged KV pool: the serving subset of
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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import NEG_INF, one_token_attention
from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.kernels.kv_quant import (KVQuantConfig, quant_scatter_multi,
                                          quant_scatter_token)
from repro_torch.models.layers import dense, rms_norm, rope

__all__ = ["init_paged_kv_cache", "paged_decode_attention_block",
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
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet")
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                     cfg.rope_theta)


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
    q, k_new = _position_encode(cfg, q, k_new, pos[:, None])
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
    q, k_new = _position_encode(cfg, q, k_new, abs_pos)

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
    positions: torch.Tensor,             # (C, T) absolute positions
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
        window=cfg.window if cfg.attention == "swa" else 0, impl=impl,
        **_scale_kw(scales))
    out = out.reshape(C, T, cfg.num_heads * cfg.head_dim).to(compute_dtype)
    return dense(p["o"], out, compute_dtype)
