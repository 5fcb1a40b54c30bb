"""Step factories: the single-device counterparts of
``repro.dist.steps.make_train_step``, ``make_serve_step`` and
``make_mixed_step``.

No mesh and no jit: a step is a plain function that runs eagerly on the
device its tensors live on.  Where the JAX steps donate the cache so XLA
updates the pool in place, these steps write in place directly: the
attention blocks ``index_put_`` each token's K/V into its frame of the
layer's view of ``cache.kv["k_pages"]``/``["v_pages"]`` (for an int8 /
fp8 pool, quantize it there and update the frame's row of
``cache.kv["k_scales"]``/``["v_scales"]``, which every step hands each
layer beside its pool view), and nothing else in the cache is written
(``pos`` advances into a new tensor; the verify step leaves it alone).
The non-paged step writes each token's K/V into its slot of the dense
cache's ``k``/``v`` in place the same way.  The train step updates the
parameters and the optimizer's moments in place (the JAX step donates
them).  On one device the reference's ``zero1`` and ``act_sharding``
have nothing to shard; sharding is ROADMAP.md queue 1, item 2.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import model as model_mod
from repro_torch.optim.adamw import adamw_update
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["make_train_step", "make_serve_step", "make_mixed_step"]


def _microbatches(batch: Dict[str, torch.Tensor], k: int):
    """The reference's split, ``x.reshape((k, B // k) + ...)`` of every
    array: microbatch i is rows [i B / k, (i + 1) B / k).  M-RoPE
    positions (3, B, S) do not split along their first axis, where that
    reshape fails in the reference too."""
    for name, x in batch.items():
        if name == "positions" or x.shape[0] % k:
            raise ValueError(
                f"batch[{name!r}] of shape {tuple(x.shape)} does not split "
                f"into {k} microbatches along its first axis")
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    shape: Optional[ShapeConfig] = None):
    """``fn(params, opt, batch) -> (params, opt, metrics)``: the loss and
    gradients of :func:`~repro_torch.models.model.train_loss` (remat
    ``tcfg.remat``), accumulated in f32 over ``tcfg.microbatches`` row
    splits of the batch and divided by their count (with
    ``grad_compression="bf16"`` each microbatch's gradients are cast to
    bf16 first), then :func:`~repro_torch.optim.adamw.adamw_update`.
    The metrics are the loss's, averaged over the microbatches, and the
    update's (``grad_norm``, ``lr``), all 0-d tensors on the device.
    Families the port cannot train raise ``NotImplementedError`` here."""
    model_mod.check_trainable(cfg)
    k = max(1, tcfg.microbatches)
    if shape is not None and shape.global_batch % k:
        raise ValueError(
            f"microbatches ({k}) must divide the global batch "
            f"({shape.global_batch})")

    def compress(g):
        return g.to(torch.bfloat16) if tcfg.grad_compression == "bf16" else g

    def grads_of(params, mb):
        """(the loss's metrics, the gradients as f32 leaves in the order
        of :func:`repro_torch.tree.leaves`, each compressed first if
        asked)."""
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = model_mod.train_loss(live, cfg, mb,
                                                 remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves(live))
        return ({name: m.detach() for name, m in metrics.items()},
                [compress(g).float() for g in grads])

    def step(params, opt, batch):
        if k == 1:
            metrics, grads = grads_of(params, batch)
        else:
            # the first microbatch's gradients are the f32 sum's start
            # (0 + g is g), the rest add into them
            grads, per_micro = None, []
            for mb in _microbatches(batch, k):
                metrics, g = grads_of(params, mb)
                per_micro.append(metrics)
                if grads is None:
                    grads = g
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x)
            for acc in grads:
                acc.div_(k)
            metrics = {name: torch.stack([m[name] for m in per_micro]).mean()
                       for name in per_micro[0]}
        params, opt, opt_metrics = adamw_update(
            unflatten(params, grads), opt, params, tcfg)
        return params, opt, {**metrics, **opt_metrics}

    return step


def make_serve_step(cfg: ModelConfig, speculate_k: int = 0, *,
                    paged: bool = True):
    """``fn(params, cache, tokens) -> (logits, cache)``: one decode token
    for every slot, on a :class:`~repro_torch.models.model.PagedCache`
    through the kernel the tensors' device selects, or with
    ``paged=False`` on a dense :class:`~repro_torch.models.model.Cache`
    (the non-paged engine); a cache of the other layout raises
    ``TypeError``.

    With ``speculate_k > 0`` (paged only): ``fn(params, cache, tokens,
    length) -> (logits, cache)``, the verify-K step — tokens (B, K + 1),
    length (B,) valid rows per slot, logits (B, K + 1, V); ``cache.pos``
    is left for the engine to advance."""
    if speculate_k and not paged:
        raise ValueError("speculate_k requires the paged serve step")
    layout = model_mod.PagedCache if paged else model_mod.Cache

    if speculate_k:
        @torch.no_grad()
        def step(params, cache, tokens, length):
            return model_mod.verify_step(params, cfg, cache, tokens, length)
    else:
        @torch.no_grad()
        def step(params, cache, tokens):
            if not isinstance(cache, layout):
                raise TypeError(f"this step decodes on a {layout.__name__}, "
                                f"got a {type(cache).__name__}")
            return model_mod.decode_step(params, cfg, cache, tokens)

    return step


def make_mixed_step(cfg: ModelConfig, speculate_k: int = 0):
    """``fn(params, cache, tokens, chunk) -> (logits, chunk_logits,
    chunk_carry, cache)``: one decode token for every running slot, then
    one prompt chunk for up to C admitting slots, in that order (as the
    JAX mixed step runs them), both on the same pool; ``chunk_carry`` is
    the chunk rows' recurrent state for their next chunk (hybrid family;
    else None).

    With ``speculate_k > 0``: ``fn(params, cache, tokens, length, chunk)``
    runs the verify-K step in place of the decode token, then the
    chunk."""

    if speculate_k:
        @torch.no_grad()
        def step(params, cache, tokens, length, chunk):
            logits, cache = model_mod.verify_step(params, cfg, cache, tokens,
                                                  length)
            chunk_logits, cache, carry = model_mod.prefill_chunk(
                params, cfg, cache, chunk)
            return logits, chunk_logits, carry, cache
    else:
        @torch.no_grad()
        def step(params, cache, tokens, chunk):
            logits, cache = model_mod.decode_step(params, cfg, cache, tokens)
            chunk_logits, cache, carry = model_mod.prefill_chunk(
                params, cfg, cache, chunk)
            return logits, chunk_logits, carry, cache

    return step
