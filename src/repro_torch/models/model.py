"""Dense and MoE decoders on the paged KV pool: the serving subset of
``repro.models.model``.

The MoE family runs with an expert block on every layer
(``moe_every == 1``, no shared expert): the reference's plain layer
stack with :func:`repro_torch.models.moe.moe_block` in place of the
SwiGLU MLP.  The grouped stack of ``moe_every > 1`` (llama4) is not
ported.

Parameters are a nested dict of tensors with the JAX package's path
names, the layer stack stacked on axis 0 (``params["layers"]["attn"]
["q"]["w"]`` is (L, d, H * D)), so :func:`repro_torch.bridge.
params_from_numpy` moves JAX weights over by name.  The layer loop is a
Python loop that hands each layer its ``(N, page, Hkv, D)`` view of the
stacked pool; the attention blocks update those views in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (init_paged_kv_cache,
                                          paged_decode_attention_block,
                                          paged_prefill_block,
                                          paged_verify_block)
from repro_torch.models.layers import embed, rms_norm, swiglu, unembed
from repro_torch.models.moe import moe_block, moe_init

Params = Dict[str, Any]

__all__ = ["init_params", "cast_params", "PagedCache", "init_paged_cache",
           "decode_step", "verify_step", "prefill_chunk", "torch_dtype",
           "family_ported"]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def family_ported(cfg: ModelConfig) -> bool:
    """A dense decoder, or an MoE one with an expert block on every layer
    and no shared expert."""
    if cfg.family == "dense":
        return not cfg.num_experts
    return (cfg.family == "moe" and cfg.num_experts > 0
            and cfg.moe_every == 1 and not cfg.shared_expert)


def _check_family(cfg: ModelConfig) -> None:
    if not family_ported(cfg):
        raise NotImplementedError(
            f"family {cfg.family!r} (experts={cfg.num_experts}, moe_every="
            f"{cfg.moe_every}, shared_expert={cfg.shared_expert}) is not "
            "ported yet; the port serves dense decoders and MoE ones with "
            "an expert block on every layer and no shared expert")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters with the JAX ``init_params`` shapes and scales
    (dense weights ~ N(0, 1/d_in), embeddings ~ N(0, 0.02²), norm scales
    1, the MoE layers' as :func:`~repro_torch.models.moe.moe_init`),
    drawn from ``generator`` on ``device`` in ``cfg.param_dtype``."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    L, d, hd, ff = cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    H, Hkv, V = cfg.num_heads, cfg.num_kv_heads, cfg.padded_vocab

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(scale)

    def w(d_in, d_out):
        return {"w": normal((L, d_in, d_out), d_in ** -0.5)}

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}

    attn = {"q": w(d, H * hd), "k": w(d, Hkv * hd), "v": w(d, Hkv * hd),
            "o": w(H * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = ones(L, hd)
        attn["k_norm"] = ones(L, hd)
    params: Params = {
        "embed": {"table": normal((V, d), 0.02)},
        "final_norm": ones(d),
        "layers": {
            "attn_norm": ones(L, d),
            "attn": attn,
            "mlp_norm": ones(L, d),
            "mlp": (moe_init(cfg, generator, device, dtype, layers=L)
                    if cfg.num_experts else
                    {"gate": w(d, ff), "up": w(d, ff), "down": w(ff, d)}),
        },
    }
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
                     cache: PagedCache, attn: Callable, cdt,
                     impl: str) -> torch.Tensor:
    """The dense or MoE layer stack shared by one-token decode,
    speculative verify and chunked prefill; ``attn(p, h, k_layer,
    v_layer, scales)`` runs one attention block on the pre-normed hidden
    ``h`` against that layer's pool view (``scales`` the layer's (k, v)
    scale rows of a quantized pool, else None).  An MoE layer's expert
    block gathers through ``impl``, each row of ``x`` its own sequence,
    as in the reference."""
    kv = cache.kv
    kp, vp = kv["k_pages"], kv["v_pages"]
    ks, vs = kv.get("k_scales"), kv.get("v_scales")
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = _layer(layers, l)
        scales = None if ks is None else (ks[l], vs[l])
        x = x + attn(lp["attn"], rms_norm(lp["attn_norm"], x, cfg.norm_eps),
                     kp[l], vp[l], scales)
        h = rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        if cfg.num_experts:
            m, _ = moe_block(lp["mlp"], cfg, h, compute_dtype=cdt, impl=impl)
        else:
            m = swiglu(lp["mlp"], h, cdt)
        x = x + m
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor, cdt):
    """(B, S, V) f32 logits of the hidden rows ``x`` (B, S, d)."""
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["lm_head"]["table"]
    logits = unembed({"table": table}, x, logit_scale=cfg.logit_scale,
                     compute_dtype=cdt)
    return logits.float()


def decode_step(params: Params, cfg: ModelConfig, cache: PagedCache,
                tokens: torch.Tensor, *, impl: str = "auto"
                ) -> Tuple[torch.Tensor, PagedCache]:
    """One-token decode.  tokens: (B, 1) int.  Writes each slot's new K/V
    into the pool in place and returns (logits (B, V) f32, cache with
    ``pos + 1``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    pos = cache.pos
    pt = cache.kv["page_table"]
    x = embed(params["embed"], tokens, cdt)

    def attn(p, h, kl, vl, scales):
        return paged_decode_attention_block(p, cfg, h, (kl, vl), pt, pos,
                                            compute_dtype=cdt, impl=impl,
                                            scales=scales)

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
    positions = offset[:, None] + torch.arange(T, dtype=torch.int32,
                                               device=toks.device)[None, :]

    def attn(p, h, kl, vl, scales):
        return paged_prefill_block(p, cfg, h, (kl, vl), page_rows, offset,
                                   length, positions, compute_dtype=cdt,
                                   impl=impl, scales=scales)

    x = _decode_families(params, cfg, x, cache, attn, cdt, impl)
    idx = torch.clamp(length - 1, 0, T - 1).long()
    x_last = x[torch.arange(C, device=x.device), idx][:, None]
    return _logits(params, cfg, x_last, cdt)[:, 0], cache
