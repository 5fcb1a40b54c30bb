"""Step factories: the single-device counterparts of
``repro.dist.steps.make_serve_step`` and ``make_mixed_step``.

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
cache's ``k``/``v`` in place the same way.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod

__all__ = ["make_serve_step", "make_mixed_step"]


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
    cache)``: one decode token for every running slot, then one prompt
    chunk for up to C admitting slots, in that order (as the JAX mixed
    step runs them), both on the same pool.

    With ``speculate_k > 0``: ``fn(params, cache, tokens, length, chunk)``
    runs the verify-K step in place of the decode token, then the
    chunk."""

    if speculate_k:
        @torch.no_grad()
        def step(params, cache, tokens, length, chunk):
            logits, cache = model_mod.verify_step(params, cfg, cache, tokens,
                                                  length)
            chunk_logits, cache = model_mod.prefill_chunk(params, cfg, cache,
                                                          chunk)
            return logits, chunk_logits, cache
    else:
        @torch.no_grad()
        def step(params, cache, tokens, chunk):
            logits, cache = model_mod.decode_step(params, cfg, cache, tokens)
            chunk_logits, cache = model_mod.prefill_chunk(params, cfg, cache,
                                                          chunk)
            return logits, chunk_logits, cache

    return step
