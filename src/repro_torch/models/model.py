"""Dense and MoE decoders: the serving subset of ``repro.models.model``.

Two layouts of the attention KV: the paged pool (:class:`PagedCache`:
one-token decode, speculative verify and chunked prefill compute on it
through the page tables) and the dense per-slot cache (:class:`Cache`:
the whole-prompt :func:`prefill` builds one, and :func:`decode_step`
decodes on one, the non-paged engine's layout).  :func:`decode_step`
takes either.

The MoE family runs with an expert block on every layer (olmoe:
``moe_every == 1``, the reference's plain layer stack with
:func:`repro_torch.models.moe.moe_block` in place of the SwiGLU MLP) or
on every ``moe_every``-th (llama4: the reference's grouped stack of
``moe_every - 1`` dense layers and one MoE layer a group, with a shared
expert); :func:`layer_params` maps layer l to its parameters in either
layout, and every layer walk (:func:`decode_step`, :func:`verify_step`,
:func:`prefill_chunk`, :func:`prefill`) goes through it.

Parameters are a nested dict of tensors with the JAX package's path
names, the layer stack stacked on axis 0 (``params["layers"]["attn"]
["q"]["w"]`` is (L, d, H * D); grouped: ``params["groups"]["dense"]``
(G, moe_every - 1, ...) and ``["moe"]`` (G, ...)), so
:func:`repro_torch.bridge.params_from_numpy` moves JAX weights over by
name.  The layer loop is a
Python loop that hands each layer its ``(N, page, Hkv, D)`` view of the
stacked pool; the attention blocks update those views in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention_block,
                                          decode_attention_block,
                                          init_kv_cache, init_paged_kv_cache,
                                          paged_decode_attention_block,
                                          paged_prefill_block,
                                          paged_verify_block, text_positions)
from repro_torch.models.layers import embed, rms_norm, swiglu, unembed
from repro_torch.models.moe import moe_block, moe_init

Params = Dict[str, Any]

__all__ = ["init_params", "cast_params", "Cache", "PagedCache", "init_cache",
           "init_paged_cache", "prefill", "decode_step", "verify_step",
           "prefill_chunk", "torch_dtype", "family_ported",
           "layer_params"]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def family_ported(cfg: ModelConfig) -> bool:
    """A dense decoder, or an MoE one: an expert block on every layer
    (olmoe) or on every ``moe_every``-th, with or without a shared expert
    (llama4's grouped stack, whose groups must tile the layers)."""
    if cfg.family == "dense":
        return not cfg.num_experts
    return (cfg.family == "moe" and cfg.num_experts > 0
            and cfg.num_layers % cfg.moe_every == 0)


def _check_family(cfg: ModelConfig) -> None:
    if not family_ported(cfg):
        raise NotImplementedError(
            f"family {cfg.family!r} (experts={cfg.num_experts}, moe_every="
            f"{cfg.moe_every}, layers={cfg.num_layers}) is not ported yet; "
            "the port serves dense decoders and MoE ones whose expert "
            "layers tile the stack")


def _grouped(cfg: ModelConfig) -> bool:
    """llama4's layout: groups of ``moe_every - 1`` dense layers and one
    MoE layer (the reference's ``params["groups"]``)."""
    return bool(cfg.num_experts) and cfg.moe_every > 1


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters with the JAX ``init_params`` shapes and scales
    (dense weights ~ N(0, 1/d_in), embeddings ~ N(0, 0.02²), norm scales
    1, the MoE layers' as :func:`~repro_torch.models.moe.moe_init`),
    drawn from ``generator`` on ``device`` in ``cfg.param_dtype``.

    The layer stack is ``params["layers"]`` (L, ...), or, for the grouped
    MoE stack, ``params["groups"]`` with ``"dense"`` (G, moe_every - 1,
    ...) and ``"moe"`` (G, ...), G = L // moe_every, as in the
    reference."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    L, d, hd, ff = cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    H, Hkv, V = cfg.num_heads, cfg.num_kv_heads, cfg.padded_vocab

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(scale)

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}

    def attn(lead):
        def w(d_in, d_out):
            return {"w": normal(lead + (d_in, d_out), d_in ** -0.5)}
        p = {"q": w(d, H * hd), "k": w(d, Hkv * hd), "v": w(d, Hkv * hd),
             "o": w(H * hd, d)}
        if cfg.qk_norm:
            p["q_norm"] = ones(*lead, hd)
            p["k_norm"] = ones(*lead, hd)
        return p

    def mlp(lead, moe: bool):
        if moe:
            return moe_init(cfg, generator, device, dtype, lead=lead)
        return {"gate": {"w": normal(lead + (d, ff), d ** -0.5)},
                "up": {"w": normal(lead + (d, ff), d ** -0.5)},
                "down": {"w": normal(lead + (ff, d), ff ** -0.5)}}

    def stack(lead, a, m):
        return {"attn_norm": ones(*lead, d), "attn": a,
                "mlp_norm": ones(*lead, d), "mlp": m}

    if _grouped(cfg):
        G = L // cfg.moe_every
        dl, ml = (G, cfg.moe_every - 1), (G,)
        params: Params = {"embed": {"table": normal((V, d), 0.02)},
                          "final_norm": ones(d)}
        params["groups"] = {
            "dense": stack(dl, attn(dl), mlp(dl, moe=False)),
            "moe": stack(ml, attn(ml), mlp(ml, moe=True))}
    else:
        # this draw order (attention, embedding, MLP) fixes the weights
        # every flat config has drawn since its port
        a = attn((L,))
        params = {"embed": {"table": normal((V, d), 0.02)},
                  "final_norm": ones(d)}
        params["layers"] = stack((L,), a, mlp((L,), bool(cfg.num_experts)))
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": normal((V, d), 0.02)}
    return params


def cast_params(params: Params, compute_dtype: Optional[torch.dtype],
                device) -> Params:
    """Move ``params`` to ``device`` and cast the matrix weights (dense
    ``w``/``b``, embedding tables, the MoE expert stacks ``gate``/``up``/
    ``down``) to ``compute_dtype`` — the cast the JAX package repeats
    inside every ``dense`` and expert einsum, done once.  Norm scales and
    the MoE router keep their dtype (the norms and the routing compute
    in f32).  Tensors already in place are returned as they are, not
    copied."""
    out = {}
    for name, leaf in params.items():
        if name == "router":
            out[name] = cast_params(leaf, None, device)
        elif isinstance(leaf, dict):
            out[name] = cast_params(leaf, compute_dtype, device)
        elif compute_dtype is not None and name in ("w", "b", "table",
                                                    "gate", "up", "down"):
            out[name] = leaf.to(device=device, dtype=compute_dtype)
        else:
            out[name] = leaf.to(device=device)
    return out


def _layer(tree: Params, l: int) -> Params:
    """Layer ``l``'s view of the stacked layer params."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def layer_params(params: Params, cfg: ModelConfig, l: int
                 ) -> Tuple[Params, bool]:
    """(layer ``l``'s params, whether its MLP is an expert block).  In
    the grouped stack layer l is group ``l // moe_every``'s dense slot
    ``l % moe_every`` or, at the last slot, its MoE layer; the KV stays
    indexed by l either way, the reference's cache layout."""
    if not _grouped(cfg):
        return _layer(params["layers"], l), bool(cfg.num_experts)
    g, slot = divmod(l, cfg.moe_every)
    groups = params["groups"]
    if slot < cfg.moe_every - 1:
        return _layer(_layer(groups["dense"], g), slot), False
    return _layer(groups["moe"], g), True


class Cache(NamedTuple):
    """Decode state in the dense layout, the JAX package's ``Cache``:
    ``kv`` the attention K/V (``k``/``v`` (L, B, S, Hkv, D) with the
    ``pos``/``slots`` scalars), ``ssm`` the recurrent state (``()`` for
    the dense and MoE families), ``cross`` the cross-attention state
    (``{}`` for them), ``pos`` (B,) each row's next absolute position.
    :func:`prefill` returns one, the non-paged engine decodes on one of
    ``max_batch`` rows, and the engine's
    :meth:`~repro_torch.serve.engine.Engine.fetch_finished` returns one
    reassembled from a finished sequence's far-tier pages."""
    kv: Dict[str, torch.Tensor]
    ssm: Any
    cross: Dict[str, torch.Tensor]
    pos: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Cache:
    """A zero dense :class:`Cache` of ``batch`` rows (an SWA ring of
    ``min(max_len, window)`` slots), positions 0."""
    _check_family(cfg)
    return Cache(kv=init_kv_cache(cfg, batch, max_len, device=device),
                 ssm=(), cross={},
                 pos=torch.zeros((batch,), dtype=torch.int32, device=device))


class PagedCache(NamedTuple):
    """Decode-time state with the attention KV in the paged pool layout:
    ``kv`` holds ``k_pages``/``v_pages`` (L, n_frames, page, Hkv, D), the
    per-slot ``page_table`` (B, pages_per_seq) int32 and, for an int8 /
    fp8 pool only, ``k_scales``/``v_scales`` (L, n_frames, Hkv) f32;
    ``pos`` (B,) int32 is each slot's next absolute position."""

    kv: Dict[str, torch.Tensor]
    pos: torch.Tensor


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     n_frames: int, page_size: int, *, device,
                     quant=None) -> PagedCache:
    """Frame ``n_frames - 1`` is the trash frame: unmapped page-table
    entries (and every entry of an empty decode slot) point there.
    ``quant`` (a :class:`~repro_torch.kernels.kv_quant.KVQuantConfig` or
    mode name) makes the pool int8 / fp8 with scales beside it;
    ``None``/"none" keeps the bf16 pool with no scale keys."""
    _check_family(cfg)
    kv = init_paged_kv_cache(cfg, n_frames, page_size, batch, max_len,
                             device=device, quant=quant)
    return PagedCache(kv=kv, pos=torch.zeros((batch,), dtype=torch.int32,
                                             device=device))


def _decode_families(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache, attn: Callable, cdt, impl: str) -> torch.Tensor:
    """The dense or MoE layer stack shared by one-token decode (on either
    layout), speculative verify and chunked prefill; ``attn(p, h,
    k_layer, v_layer, scales)`` runs one attention block on the
    pre-normed hidden ``h`` against that layer's view of the pool (or of
    the dense cache; ``scales`` the layer's (k, v) scale rows of a
    quantized pool, else None).  An MoE layer's expert block gathers
    through ``impl``, each row of ``x`` its own sequence, as in the
    reference."""
    kv = cache.kv
    paged = isinstance(cache, PagedCache)
    kp, vp = (kv["k_pages"], kv["v_pages"]) if paged else (kv["k"], kv["v"])
    ks, vs = kv.get("k_scales"), kv.get("v_scales")
    for l in range(cfg.num_layers):
        lp, is_moe = layer_params(params, cfg, l)
        scales = None if ks is None else (ks[l], vs[l])
        x = x + attn(lp["attn"], rms_norm(lp["attn_norm"], x, cfg.norm_eps),
                     kp[l], vp[l], scales)
        x = x + _mlp(lp, cfg, x, is_moe, cdt, impl)
    return x


def _mlp(lp: Params, cfg: ModelConfig, x: torch.Tensor, is_moe: bool, cdt,
         impl: str) -> torch.Tensor:
    """A layer's MLP on the pre-norm of ``x``: the expert block (its
    gathers through ``impl``) or the SwiGLU."""
    h = rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
    if is_moe:
        return moe_block(lp["mlp"], cfg, h, compute_dtype=cdt, impl=impl)[0]
    return swiglu(lp["mlp"], h, cdt)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor, cdt):
    """(B, S, V) f32 logits of the hidden rows ``x`` (B, S, d)."""
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["lm_head"]["table"]
    logits = unembed({"table": table}, x, logit_scale=cfg.logit_scale,
                     compute_dtype=cdt)
    return logits.float()


def decode_step(params: Params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                *, impl: str = "auto"):
    """One-token decode on a :class:`PagedCache` or a dense
    :class:`Cache`.  tokens: (B, 1) int.  Writes each slot's new K/V into
    the pool (or the dense cache) in place and returns (logits (B, V)
    f32, cache with ``pos + 1``).  The dense cache's attention is the
    plain one-token attention, as in the reference; ``impl`` then
    reaches only an MoE layer's gathers."""
    cdt = torch_dtype(cfg.compute_dtype)
    pos = cache.pos
    x = embed(params["embed"], tokens, cdt)
    if isinstance(cache, PagedCache):
        pt = cache.kv["page_table"]

        def attn(p, h, kl, vl, scales):
            return paged_decode_attention_block(
                p, cfg, h, (kl, vl), pt, pos, compute_dtype=cdt, impl=impl,
                scales=scales)
    else:
        def attn(p, h, kl, vl, scales):
            return decode_attention_block(p, cfg, h, (kl, vl), pos,
                                          compute_dtype=cdt)

    x = _decode_families(params, cfg, x, cache, attn, cdt, impl)
    return _logits(params, cfg, x, cdt)[:, 0], cache._replace(pos=pos + 1)


def verify_step(params: Params, cfg: ModelConfig, cache: PagedCache,
                tokens: torch.Tensor, length: torch.Tensor, *,
                impl: str = "auto") -> Tuple[torch.Tensor, PagedCache]:
    """Speculative verify-K decode: score S = K + 1 tokens per slot in
    one step.  tokens: (B, S) int — row 0 the last committed token, rows
    1..K the drafted continuation; length: (B,) int32 valid rows per
    slot (0 marks an inert slot, whose K/V all scatter to the trash
    frame).  Returns (logits (B, S, V) f32, cache).

    Logits row ``s`` predicts the token at position ``pos + s + 1``.
    ``cache.pos`` is NOT advanced: how many rows commit is decided on the
    host after the argmax comparison, and the engine writes the rewound
    positions back.  Paged cache, dense or MoE family, no SWA only."""
    if not isinstance(cache, PagedCache):
        raise ValueError("verify_step requires a PagedCache")
    _check_family(cfg)
    if cfg.attention == "swa":
        raise ValueError("speculative verify has no SWA ring semantics")
    cdt = torch_dtype(cfg.compute_dtype)
    pos = cache.pos
    pt = cache.kv["page_table"]
    x = embed(params["embed"], tokens, cdt)

    def attn(p, h, kl, vl, scales):
        return paged_verify_block(p, cfg, h, (kl, vl), pt, pos, length,
                                  compute_dtype=cdt, impl=impl,
                                  scales=scales)

    x = _decode_families(params, cfg, x, cache, attn, cdt, impl)
    return _logits(params, cfg, x, cdt), cache


def prefill_chunk(params: Params, cfg: ModelConfig, cache: PagedCache,
                  chunk: Dict[str, torch.Tensor], *, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, PagedCache]:
    """Run one prompt chunk for up to C admitting slots on the pool layout.

    ``chunk`` keys (C rows, T token capacity), all int32 tensors on the
    cache's device: ``tokens`` (C, T), ``offset``/``length`` (C,) and
    ``page_rows`` (C, pages_per_seq) — as in the JAX package (a
    ``length == 0`` row is inert: its K/V lands in the trash frame).
    Returns (logits (C, V) f32 at each row's last valid token, cache);
    the pool frames are updated in place.
    """
    cdt = torch_dtype(cfg.compute_dtype)
    toks = chunk["tokens"]
    C, T = toks.shape
    offset, length = chunk["offset"], chunk["length"]
    page_rows = chunk["page_rows"]
    x = embed(params["embed"], toks, cdt)
    positions = text_positions(cfg, offset[:, None] + torch.arange(
        T, dtype=torch.int32, device=toks.device)[None, :])

    def attn(p, h, kl, vl, scales):
        return paged_prefill_block(p, cfg, h, (kl, vl), page_rows, offset,
                                   length, positions, compute_dtype=cdt,
                                   impl=impl, scales=scales)

    x = _decode_families(params, cfg, x, cache, attn, cdt, impl)
    idx = torch.clamp(length - 1, 0, T - 1).long()
    x_last = x[torch.arange(C, device=x.device), idx][:, None]
    return _logits(params, cfg, x_last, cdt)[:, 0], cache


def _cache_fit(k: torch.Tensor, v: torch.Tensor, slots: int):
    """Keep the last ``slots`` positions of (B, S, Hkv, D) K/V, rolled so
    that absolute position ``p`` lands in ring slot ``p % slots`` (decode
    then overwrites the oldest entry).  S counts the padded bucket, as
    in the reference."""
    S = k.shape[1]
    if S <= slots:
        return k, v
    shift = S % slots
    return (torch.roll(k[:, -slots:], shift, dims=1),
            torch.roll(v[:, -slots:], shift, dims=1))


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None,
            last_pos: Optional[torch.Tensor] = None,
            impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """Whole-prompt prefill of the dense and MoE families: tokens (B, S)
    int, the prompt padded to its bucket.  Every layer attends the whole
    sequence causally through :func:`~repro_torch.models.attention.
    attention_block` (the dense flash attention kernel on the card) and
    its K/V goes into a dense :class:`Cache` sized for ``max_len``
    (default S): all S positions, or, where an SWA ring of ``min(max_len,
    window)`` slots is shorter, its last ``slots``, rolled
    (:func:`_cache_fit`).  ``last_pos`` (B,) picks the position
    whose logits are returned (default S - 1): the engine passes the
    prompt's last real token, so the padded tail never reaches a sampled
    token.  Returns (logits (B, V) f32, cache with ``pos`` = S)."""
    _check_family(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    B, S = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, B, max_len or S, device=dev)
    kc = cache.kv["k"]
    slots = kc.shape[2]
    fit = min(S, slots)
    k_all = torch.empty((cfg.num_layers, B, fit) + tuple(kc.shape[3:]),
                        dtype=kc.dtype, device=dev)
    v_all = torch.empty_like(k_all)
    positions = text_positions(cfg, torch.arange(
        S, dtype=torch.int32, device=dev).expand(B, S))
    x = embed(params["embed"], tokens, cdt)
    for l in range(cfg.num_layers):
        lp, is_moe = layer_params(params, cfg, l)
        a, (k, v) = attention_block(
            lp["attn"], cfg, rms_norm(lp["attn_norm"], x, cfg.norm_eps),
            positions, compute_dtype=cdt, impl=impl)
        x = x + a
        x = x + _mlp(lp, cfg, x, is_moe, cdt, impl)
        k, v = _cache_fit(k, v, slots)
        k_all[l], v_all[l] = k, v
    if last_pos is None:
        x_last = x[:, -1:]
    else:
        idx = torch.clamp(last_pos.long(), 0, S - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None]
    logits = _logits(params, cfg, x_last, cdt)[:, 0]
    kv = dict(cache.kv, k=k_all, v=v_all)
    return logits, cache._replace(
        kv=kv, pos=torch.full((B,), S, dtype=torch.int32, device=dev))
