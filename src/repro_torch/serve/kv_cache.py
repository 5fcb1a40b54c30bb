"""Serving-side KV management: slot pool, aux residue and page helpers.

The paged engine's device cache is the
:class:`~repro_torch.models.model.PagedCache` (pool frames + page
tables) and the KV never leaves its frames; the non-paged engine's is a
dense :class:`~repro_torch.models.model.Cache` of ``max_batch`` rows.
This module is the bookkeeping around both, the port of the JAX
package's ``serve/kv_cache.py``:

  * :class:`SlotPool` — fixed decode slots, heap-backed alloc/free,
  * :func:`extract_slot` / :func:`insert_slot` — whole-slot moves of the
    dense cache: a prefilled single-sequence cache goes into its slot,
  * :func:`extract_aux_slot` / :func:`insert_aux_slot` — the *non-KV*
    park payload (SSM state, cross-attention state, the position): the
    residue every park, finished-sequence offload and handoff carries,
    as host (CPU) tensors,
  * :func:`split_kv_pages` / :func:`join_kv_pages` — carve a
    single-sequence :class:`~repro_torch.models.model.Cache` into
    page-granularity host payloads and back, bit-exact.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.amu import AMUError
from repro_torch.models.model import Cache
from repro_torch.paging.page_table import pages_for

__all__ = ["SlotPool", "tree_map", "extract_slot", "insert_slot",
           "extract_aux_slot", "insert_aux_slot", "split_kv_pages",
           "join_kv_pages"]


class SlotPool:
    """Fixed decode slots.  The free list is a min-heap so alloc/release
    are O(log n) and ids hand out lowest-first.

    Example::

        pool = SlotPool(4)
        slot = pool.alloc()        # -> 0 (lowest first)
        pool.release(slot)
        pool.release(slot)         # raises AMUError (double release)
    """

    def __init__(self, n_slots: int):
        self.free: List[int] = list(range(n_slots))
        heapq.heapify(self.free)
        self._is_free = [True] * n_slots
        self.n_slots = n_slots

    def alloc(self) -> Optional[int]:
        if not self.free:
            return None
        slot = heapq.heappop(self.free)
        self._is_free[slot] = False
        return slot

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise AMUError(f"release of invalid slot {slot} "
                           f"(pool has {self.n_slots})")
        if self._is_free[slot]:
            raise AMUError(f"double release of slot {slot}")
        self._is_free[slot] = True
        heapq.heappush(self.free, slot)

    @property
    def n_free(self) -> int:
        return len(self.free)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the tensor leaves of dict / tuple / NamedTuple
    trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def _slot_axis(leaf: torch.Tensor, n_slots: int) -> Optional[int]:
    """The batch axis of a per-slot leaf: 1 for stacked-over-layers
    state, 0 for per-slot rows, None for shared leaves."""
    if leaf.ndim >= 2 and leaf.shape[1] == n_slots:
        return 1
    if leaf.ndim >= 1 and leaf.shape[0] == n_slots:
        return 0
    return None


def extract_slot(cache: Cache, slot: int, n_slots: int) -> Cache:
    """Copy one sequence's state out of the batched dense cache, batch
    dim kept at 1 (shared leaves, such as the ``pos``/``slots`` scalars
    of ``kv``, as they are)."""
    def ex(leaf):
        axis = _slot_axis(leaf, n_slots)
        return leaf if axis is None else leaf.narrow(axis, slot, 1).clone()
    return tree_map(ex, cache)


def insert_slot(cache: Cache, single: Cache, slot: int, n_slots: int
                ) -> Cache:
    """Write a single-sequence cache (batch dim 1) into ``slot`` of the
    batched dense cache, in place, and return the cache.  A leaf shorter
    than the slot's (a prefill bucket below ``max_len``) fills the slot
    from position 0, as the reference's ``dynamic_update_slice`` does;
    the rest of the slot keeps what it held, never attended."""
    def ins(dst, src):
        axis = _slot_axis(dst, n_slots)
        if axis is None:
            return
        view = dst.narrow(axis, slot, 1)
        for ax, n in enumerate(src.shape):
            if ax != axis and n != view.shape[ax]:
                view = view.narrow(ax, 0, n)
        view.copy_(src)
    tree_map(ins, cache, single)
    return cache


def extract_aux_slot(cache, slot: int, n_slots: int) -> Dict[str, Any]:
    """Copy one sequence's *non-KV* state (ssm, cross, pos) to the host.

    The paged engine's park payload: the KV never leaves its page
    frames, so a park, a finished-sequence offload and a handoff all
    carry only this remainder.  For the dense and MoE families the
    residue is ``{"ssm": (), "cross": {}, "pos": (1,) int32}``; for the
    hybrid family ``ssm`` is the slot's MambaState, leaves (L, 1, ...)."""
    def ex(leaf):
        axis = _slot_axis(leaf, n_slots)
        if axis is not None:
            leaf = leaf.narrow(axis, slot, 1)
        return leaf.to("cpu", copy=True)
    return {"ssm": tree_map(ex, getattr(cache, "ssm", ())),
            "cross": tree_map(ex, getattr(cache, "cross", {})),
            "pos": cache.pos[slot:slot + 1].to("cpu", copy=True)}


def insert_aux_slot(cache, aux: Dict[str, Any], slot: int, n_slots: int):
    """Write an :func:`extract_aux_slot` payload back into ``slot`` of
    ``cache``, in place, and return the cache.  The payload is only
    read: a residue that lives in the far tier may be shared."""
    def ins(dst, src):
        axis = _slot_axis(dst, n_slots)
        if axis is not None:
            dst.narrow(axis, slot, 1).copy_(src)
    for name in ("ssm", "cross"):
        if hasattr(cache, name):
            tree_map(ins, getattr(cache, name), aux[name])
    cache.pos[slot:slot + 1].copy_(aux["pos"])
    return cache


def split_kv_pages(single: Cache, page_size: int, n_tokens: int
                   ) -> Tuple[Cache, List[Dict[str, torch.Tensor]]]:
    """Carve a single-sequence cache into (residue, KV pages).

    Page ``i`` holds token positions ``[i*page_size, (i+1)*page_size)``
    of the stacked k/v — shape ``(L, 1, page_size, Hkv, D)`` each, the
    last page clamped to the valid tokens — as host tensors.  The
    residue is the cache with k/v emptied to zero positions.
    ``n_tokens`` is clamped to the KV token axis."""
    k, v = single.kv["k"], single.kv["v"]
    valid = min(n_tokens, int(k.shape[2]))
    pages = []
    for i in range(pages_for(valid, page_size)):
        lo, hi = i * page_size, min((i + 1) * page_size, valid)
        pages.append({"k": k[:, :, lo:hi].to("cpu", copy=True),
                      "v": v[:, :, lo:hi].to("cpu", copy=True)})
    residue = single._replace(kv=dict(
        single.kv, k=k[:, :, :0].to("cpu", copy=True),
        v=v[:, :, :0].to("cpu", copy=True)))
    return residue, pages


def join_kv_pages(residue: Cache, pages: List[Dict[str, torch.Tensor]],
                  token_capacity: int) -> Cache:
    """Inverse of :func:`split_kv_pages`: reassemble the single-sequence
    cache with its KV materialised from pages into a ``token_capacity``-
    long buffer of the residue's dtype (positions past the last page
    stay zero — never attended)."""
    L, B, _, Hkv, D = residue.kv["k"].shape
    total = sum(pg["k"].shape[2] for pg in pages)
    if total > token_capacity:
        raise AMUError(
            f"pages hold {total} tokens > capacity {token_capacity}")
    k = torch.zeros((L, B, token_capacity, Hkv, D),
                    dtype=residue.kv["k"].dtype)
    v = torch.zeros((L, B, token_capacity, Hkv, D),
                    dtype=residue.kv["v"].dtype)
    off = 0
    for pg in pages:
        n = pg["k"].shape[2]
        k[:, :, off:off + n] = pg["k"]
        v[:, :, off:off + n] = pg["v"]
        off += n
    return residue._replace(kv=dict(residue.kv, k=k, v=v))
