"""Dense, MoE, SSM and hybrid decoders: the serving subset of
``repro.models.model``.

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

The SSM family (rwkv6) is a stack of RWKV6 layers with no attention:
its cache is the recurrent state alone (``Cache.ssm``, an
:class:`~repro_torch.models.ssm.RWKVState` stacked over layers), so it
has no KV to page.  The hybrid family (zamba2) is a stack of Mamba2
layers in groups of ``shared_attn_every`` (``params["mamba_groups"]``
(G, every, ...), the rest ``params["mamba_tail"]``) with one shared
attention + MLP block (``params["shared_attn"]``) after each group, the
KV of G attention layers and a :class:`~repro_torch.models.ssm.
MambaState` per Mamba2 layer.  Their full-sequence layers run the
recurrence kernels (``ops.wkv6``, ``ops.ssd``) with the state carried in
and out; a prompt served in chunks carries it from chunk to chunk
(:func:`prefill_chunk`'s carry), and the one-token step continues it.

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
from repro_torch.models.ssm import (mamba2_seq, mamba2_state_init,
                                    mamba2_step, rwkv6_block,
                                    rwkv6_state_init, rwkv6_step)

Params = Dict[str, Any]

__all__ = ["init_params", "cast_params", "Cache", "PagedCache", "init_cache",
           "init_paged_cache", "init_ssm_state", "prefill", "decode_step",
           "verify_step", "prefill_chunk", "torch_dtype", "family_ported",
           "layer_params", "hybrid_layout", "kv_layers"]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def family_ported(cfg: ModelConfig) -> bool:
    """A dense decoder, or an MoE one: an expert block on every layer
    (olmoe) or on every ``moe_every``-th, with or without a shared expert
    (llama4's grouped stack, whose groups must tile the layers); or the
    SSM (RWKV6) or the hybrid (Mamba2 + shared attention) family.  The
    encoder-decoder family is not ported yet."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.family == "dense":
        return not cfg.num_experts
    return (cfg.family == "moe" and cfg.num_experts > 0
            and cfg.num_layers % cfg.moe_every == 0)


def _check_family(cfg: ModelConfig) -> None:
    if not family_ported(cfg):
        raise NotImplementedError(
            f"family {cfg.family!r} (experts={cfg.num_experts}, moe_every="
            f"{cfg.moe_every}, layers={cfg.num_layers}) is not ported yet; "
            "the port serves dense decoders, MoE ones whose expert layers "
            "tile the stack, and the SSM and hybrid families")


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(every, groups, tail) of the hybrid stack: G = L // every groups of
    ``every`` Mamba2 layers, each followed by the shared block, then
    ``tail`` Mamba2 layers; the KV has G layers."""
    every = cfg.shared_attn_every or cfg.num_layers
    groups = cfg.num_layers // every
    return every, groups, cfg.num_layers - groups * every


def kv_layers(cfg: ModelConfig) -> int:
    """Layers of attention KV: one per layer, the shared block's G in the
    hybrid family, none in the SSM family."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return hybrid_layout(cfg)[1]
    return cfg.num_layers


def _mamba_layer(params: Params, cfg: ModelConfig, l: int) -> Params:
    """Mamba2 layer ``l``'s params: group ``l // every``'s layer ``l %
    every``, or past the groups the tail's."""
    every, G, _ = hybrid_layout(cfg)
    if l < G * every:
        return _layer(_layer(params["mamba_groups"], l // every), l % every)
    return _layer(params["mamba_tail"], l - G * every)


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

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    if cfg.family in ("ssm", "hybrid"):
        params = {"embed": {"table": normal((V, d), 0.02)},
                  "final_norm": ones(d)}
        if cfg.family == "ssm":
            params["layers"] = _rwkv6_params(cfg, (L,), normal, full)
        else:
            every, G, tail = hybrid_layout(cfg)
            params["mamba_groups"] = _mamba2_params(cfg, (max(G, 1), every),
                                                    normal, full)
            if tail:
                params["mamba_tail"] = _mamba2_params(cfg, (tail,), normal,
                                                      full)
            params["shared_attn"] = stack((), attn(()), mlp((), False))
    elif _grouped(cfg):
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


def _rwkv6_params(cfg: ModelConfig, lead, normal, full) -> Params:
    """RWKV6 layers stacked over ``lead``, the reference's
    ``rwkv6_init`` shapes and scales (a data-dependent decay of LoRA rank
    64, token-shift lerps of 0.5, per-head group norms)."""
    d, ff, H, K = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    lora = 64

    def w(d_in, d_out):
        return {"w": normal(lead + (d_in, d_out), d_in ** -0.5)}

    def ln(*shape):
        return {"scale": full(lead + shape, 1.0),
                "bias": full(lead + shape, 0.0)}

    return {
        "ln1": ln(d), "ln2": ln(d),
        "mu": {n: full(lead + (d,), 0.5) for n in ("r", "k", "v", "g", "w")},
        "Wr": w(d, H * K), "Wk": w(d, H * K), "Wv": w(d, H * K),
        "Wg": w(d, H * K), "Wo": w(H * K, d),
        "w0": full(lead + (H * K,), -2.0),
        "wA": normal(lead + (d, lora), d ** -0.5 * 0.1),
        "wB": normal(lead + (lora, H * K), 0.01),
        "u": normal(lead + (H, K), 0.1),
        "gn": ln(H, K),
        "cm_mu": {n: full(lead + (d,), 0.5) for n in ("k", "r")},
        "cWk": w(d, ff), "cWv": w(ff, d), "cWr": w(d, d),
    }


def _mamba2_params(cfg: ModelConfig, lead, normal, full) -> Params:
    """Mamba2 layers stacked over ``lead``, the reference's
    ``mamba2_init`` shapes and scales (A = 1..16 over the heads, D 1)."""
    d, di, N, P = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.head_dim
    H, conv_dim = di // P, di + 2 * N
    a_log = full(lead + (H,), 0.0)
    a_log.copy_(torch.log(torch.linspace(1.0, 16.0, H).to(a_log.dtype)))
    return {
        "norm": {"scale": full(lead + (d,), 1.0)},
        "in_proj": {"w": normal(lead + (d, 2 * di + 2 * N + H), d ** -0.5)},
        "conv_w": normal(lead + (cfg.ssm_conv, conv_dim), 0.2),
        "conv_b": full(lead + (conv_dim,), 0.0),
        "A_log": a_log,
        "D": full(lead + (H,), 1.0),
        "dt_bias": full(lead + (H,), 0.0),
        "gate_norm": {"scale": full(lead + (di,), 1.0)},
        "out_proj": {"w": normal(lead + (di, d), di ** -0.5)},
    }


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
    ``pos``/``slots`` scalars; ``{}`` for the SSM family, G layers for the
    hybrid one), ``ssm`` the recurrent state (an
    :class:`~repro_torch.models.ssm.RWKVState` or
    :class:`~repro_torch.models.ssm.MambaState` with leaves (L, B, ...),
    ``()`` for the dense and MoE families), ``cross`` the
    cross-attention state (``{}``), ``pos`` (B,) each row's next absolute
    position.  :func:`prefill` returns one, the non-paged engine decodes
    on one of ``max_batch`` rows, and the engine's
    :meth:`~repro_torch.serve.engine.Engine.fetch_finished` returns one
    reassembled from a finished sequence's far-tier pages."""
    kv: Dict[str, torch.Tensor]
    ssm: Any
    cross: Dict[str, torch.Tensor]
    pos: torch.Tensor


def init_ssm_state(cfg: ModelConfig, batch: int, *, device):
    """The zero recurrent state of ``batch`` rows, its leaves stacked
    over the layers (L, batch, ...): an RWKVState (SSM family), a
    MambaState (hybrid), or ``()``."""
    if cfg.family == "ssm":
        one = rwkv6_state_init(cfg, batch, device=device)
    elif cfg.family == "hybrid":
        one = mamba2_state_init(cfg, batch, device=device)
    else:
        return ()
    return type(one)(*(a.expand((cfg.num_layers,) + a.shape).clone()
                       for a in one))


def _stack_states(states):
    """Per-layer states (a list of one NamedTuple each) -> one NamedTuple
    with its leaves stacked over the layers."""
    return type(states[0])(*(torch.stack(t) for t in zip(*states)))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Cache:
    """A zero dense :class:`Cache` of ``batch`` rows (an SWA ring of
    ``min(max_len, window)`` slots; :func:`kv_layers` layers of KV),
    positions 0."""
    _check_family(cfg)
    n_kv = kv_layers(cfg)
    kv = (init_kv_cache(cfg, batch, max_len, device=device, n_layers=n_kv)
          if n_kv else {})
    return Cache(kv=kv, ssm=init_ssm_state(cfg, batch, device=device),
                 cross={},
                 pos=torch.zeros((batch,), dtype=torch.int32, device=device))


class PagedCache(NamedTuple):
    """Decode-time state with the attention KV in the paged pool layout:
    ``kv`` holds ``k_pages``/``v_pages`` (L, n_frames, page, Hkv, D), the
    per-slot ``page_table`` (B, pages_per_seq) int32 and, for an int8 /
    fp8 pool only, ``k_scales``/``v_scales`` (L, n_frames, Hkv) f32;
    ``pos`` (B,) int32 is each slot's next absolute position; ``ssm`` the
    hybrid family's recurrent state in the dense per-slot layout (tiny
    beside the KV, never paged), ``()`` for the others."""

    kv: Dict[str, torch.Tensor]
    pos: torch.Tensor
    ssm: Any = ()


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     n_frames: int, page_size: int, *, device,
                     quant=None) -> PagedCache:
    """Frame ``n_frames - 1`` is the trash frame: unmapped page-table
    entries (and every entry of an empty decode slot) point there.
    ``quant`` (a :class:`~repro_torch.kernels.kv_quant.KVQuantConfig` or
    mode name) makes the pool int8 / fp8 with scales beside it;
    ``None``/"none" keeps the bf16 pool with no scale keys.  ValueError
    for the SSM family, which has no KV."""
    _check_family(cfg)
    if not kv_layers(cfg):
        raise ValueError(f"family {cfg.family!r} has no KV to page")
    kv = init_paged_kv_cache(cfg, n_frames, page_size, batch, max_len,
                             device=device, n_layers=kv_layers(cfg),
                             quant=quant)
    return PagedCache(kv=kv, pos=torch.zeros((batch,), dtype=torch.int32,
                                             device=device),
                      ssm=init_ssm_state(cfg, batch, device=device))


def _layer_attn(cache, attn: Callable) -> Callable:
    """``fn(p, h, l)``: ``attn(p, h, k_layer, v_layer, scales)`` on KV
    layer ``l``'s view of the pool (or of the dense cache), with that
    layer's (k, v) scale rows of a quantized pool, else None."""
    kv = cache.kv
    paged = isinstance(cache, PagedCache)
    kp, vp = (kv["k_pages"], kv["v_pages"]) if paged else (kv["k"], kv["v"])
    ks, vs = kv.get("k_scales"), kv.get("v_scales")

    def run(p, h, l):
        return attn(p, h, kp[l], vp[l], None if ks is None else (ks[l], vs[l]))
    return run


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
    layer_attn = _layer_attn(cache, attn)
    for l in range(cfg.num_layers):
        lp, is_moe = layer_params(params, cfg, l)
        x = x + layer_attn(lp["attn"],
                           rms_norm(lp["attn_norm"], x, cfg.norm_eps), l)
        x = x + _mlp(lp, cfg, x, is_moe, cdt, impl)
    return x


def _hybrid_stack(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  mamba: Callable, attn: Callable, cdt) -> torch.Tensor:
    """The hybrid family's layer walk, shared by the prefill, the
    one-token step and the chunk: Mamba2 layer l through ``mamba(l, lp,
    x) -> x``; after each whole group the shared attention + MLP block,
    its attention through ``attn(p, h, g)`` on KV layer g (the
    reference's ``_decode_hybrid`` / ``_prefill_hybrid`` /
    ``_chunk_hybrid`` structure)."""
    every, G, _ = hybrid_layout(cfg)
    shared = params["shared_attn"]
    for l in range(cfg.num_layers):
        x = mamba(l, _mamba_layer(params, cfg, l), x)
        if l < G * every and l % every == every - 1:
            x = x + attn(shared["attn"],
                         rms_norm(shared["attn_norm"], x, cfg.norm_eps),
                         l // every)
            x = x + swiglu(shared["mlp"], rms_norm(shared["mlp_norm"], x,
                                                   cfg.norm_eps), cdt)
    return x


def _state_of(st, l: int):
    """Layer ``l``'s view of a state stacked over layers."""
    return type(st)(*(a[l] for a in st))


def _write_state(st, l: int, new) -> None:
    """Copy ``new`` into layer ``l`` of the stacked state ``st``, in
    place."""
    for dst, src in zip(st, new):
        dst[l].copy_(src)


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
    the pool (or the dense cache) and each layer's new recurrent state
    into ``cache.ssm`` in place, and returns (logits (B, V) f32, cache
    with ``pos + 1``).  The dense cache's attention is the plain
    one-token attention, as in the reference; ``impl`` then reaches only
    an MoE layer's gathers.  The SSM family decodes on a dense cache
    only (it has no KV to page)."""
    cdt = torch_dtype(cfg.compute_dtype)
    pos = cache.pos
    x = embed(params["embed"], tokens, cdt)
    if isinstance(cache, PagedCache):
        if cfg.family == "ssm":
            raise ValueError("family 'ssm' has no KV to page")
        pt = cache.kv["page_table"]

        def attn(p, h, kl, vl, scales):
            return paged_decode_attention_block(
                p, cfg, h, (kl, vl), pt, pos, compute_dtype=cdt, impl=impl,
                scales=scales)
    else:
        def attn(p, h, kl, vl, scales):
            return decode_attention_block(p, cfg, h, (kl, vl), pos,
                                          compute_dtype=cdt)

    st = cache.ssm
    if cfg.family == "ssm":
        for l in range(cfg.num_layers):
            x, new = rwkv6_step(_layer(params["layers"], l), cfg, x,
                                _state_of(st, l), compute_dtype=cdt)
            _write_state(st, l, new)
    elif cfg.family == "hybrid":
        def mamba(l, lp, x):
            x, new = mamba2_step(lp, cfg, x, _state_of(st, l),
                                 compute_dtype=cdt)
            _write_state(st, l, new)
            return x
        x = _hybrid_stack(params, cfg, x, mamba, _layer_attn(cache, attn),
                          cdt)
    else:
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
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"speculative verify not supported for family {cfg.family!r}")
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
                  chunk: Dict[str, Any], *, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, PagedCache, Any]:
    """Run one prompt chunk for up to C admitting slots on the pool layout.

    ``chunk`` keys (C rows, T token capacity), all int32 tensors on the
    cache's device: ``tokens`` (C, T), ``offset``/``length`` (C,) and
    ``page_rows`` (C, pages_per_seq) — as in the JAX package (a
    ``length == 0`` row is inert: its K/V lands in the trash frame); for
    the hybrid family also ``ssm``, the rows' recurrent state so far (a
    :class:`~repro_torch.models.ssm.MambaState` with leaves (L, C, ...)),
    and every row holds T real tokens (pad tokens would enter the
    state).  Returns (logits (C, V) f32 at each row's last valid token,
    cache, carry): the pool frames are updated in place, and the carry is
    the rows' state after the chunk for their next chunk (hybrid; else
    None).  ValueError for the SSM family, which has no KV to page.
    """
    if cfg.family == "ssm":
        raise ValueError("family 'ssm' has no KV to page")
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

    carry = None
    if cfg.family == "hybrid":
        st_in, states = chunk["ssm"], []

        def mamba(l, lp, x):
            x, new = mamba2_seq(lp, cfg, x, state=_state_of(st_in, l),
                                compute_dtype=cdt, impl=impl)
            states.append(new)
            return x
        x = _hybrid_stack(params, cfg, x, mamba, _layer_attn(cache, attn),
                          cdt)
        carry = _stack_states(states)
    else:
        x = _decode_families(params, cfg, x, cache, attn, cdt, impl)
    idx = torch.clamp(length - 1, 0, T - 1).long()
    x_last = x[torch.arange(C, device=x.device), idx][:, None]
    return _logits(params, cfg, x_last, cdt)[:, 0], cache, carry


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
    """Whole-prompt prefill: tokens (B, S) int, the prompt padded to its
    bucket (the SSM and hybrid families take it at its exact length: pad
    tokens would enter the state).  Every attention layer attends the
    whole sequence causally through :func:`~repro_torch.models.attention.
    attention_block` (the dense flash attention kernel on the card) and
    its K/V goes into a dense :class:`Cache` sized for ``max_len``
    (default S): all S positions, or, where an SWA ring of ``min(max_len,
    window)`` slots is shorter, its last ``slots``, rolled
    (:func:`_cache_fit`).  The recurrent layers run their full-sequence
    forms from a zero state (the recurrence kernels on the card) and
    leave their final state in ``cache.ssm``.  ``last_pos`` (B,) picks
    the position whose logits are returned (default S - 1): the engine
    passes the prompt's last real token, so the padded tail never
    reaches a sampled token.  Returns (logits (B, V) f32, cache with
    ``pos`` = S)."""
    _check_family(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    B, S = tokens.shape
    dev = tokens.device
    kv, n_kv = {}, kv_layers(cfg)
    x = embed(params["embed"], tokens, cdt)
    if n_kv:
        # an empty (batch 0) cache gives the slots and the dtype
        kv = init_kv_cache(cfg, 0, max_len or S, device=dev, n_layers=n_kv)
        kc = kv["k"]
        slots = kc.shape[2]
        k_all = torch.empty((n_kv, B, min(S, slots)) + tuple(kc.shape[3:]),
                            dtype=kc.dtype, device=dev)
        v_all = torch.empty_like(k_all)
        positions = text_positions(cfg, torch.arange(
            S, dtype=torch.int32, device=dev).expand(B, S))

        def attn(p, h, l):
            a, (k, v) = attention_block(p, cfg, h, positions,
                                        compute_dtype=cdt, impl=impl)
            k_all[l], v_all[l] = _cache_fit(k, v, slots)
            return a
        kv = dict(kv, k=k_all, v=v_all)
    ssm, states = (), []
    if cfg.family == "ssm":
        for l in range(cfg.num_layers):
            x, st = rwkv6_block(_layer(params["layers"], l), cfg, x,
                                return_state=True, compute_dtype=cdt,
                                impl=impl)
            states.append(st)
        ssm = _stack_states(states)
    elif cfg.family == "hybrid":
        def mamba(l, lp, x):
            x, st = mamba2_seq(lp, cfg, x, compute_dtype=cdt, impl=impl)
            states.append(st)
            return x
        x = _hybrid_stack(params, cfg, x, mamba, attn, cdt)
        ssm = _stack_states(states)
    else:
        for l in range(cfg.num_layers):
            lp, is_moe = layer_params(params, cfg, l)
            x = x + attn(lp["attn"], rms_norm(lp["attn_norm"], x,
                                              cfg.norm_eps), l)
            x = x + _mlp(lp, cfg, x, is_moe, cdt, impl)
    if last_pos is None:
        x_last = x[:, -1:]
    else:
        idx = torch.clamp(last_pos.long(), 0, S - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None]
    logits = _logits(params, cfg, x_last, cdt)[:, 0]
    return logits, Cache(
        kv=kv, ssm=ssm, cross={},
        pos=torch.full((B,), S, dtype=torch.int32, device=dev))
