"""Content-addressed cross-request prefix sharing over the page pool.

Host code on numpy token ids, a copy of the JAX package's
``paging/prefix_cache.py``: :func:`page_hashes` gives the same bytes.

Serving fleets see the same prompt prefixes over and over — a system
prompt shared by thousands of users, a few-shot template, a long
retrieval document.  Recomputing the prefix's KV per request burns the
exact prefill FLOPs chunked admission was built to hide.  This module
makes prompt pages *content-addressed*: a full page of prompt tokens is
identified by a rolling hash of the token-id prefix it terminates, so
any later request whose prompt starts with the same tokens can map its
page-table rows straight onto the already-computed KV — device-resident
(refcounted frame share, zero traffic) or far-tier (one LATENCY-QoS
page fetch instead of a prefill chunk).

Design notes:

  * **Full pages only.**  A page hash covers tokens
    ``[0, (i+1) * page_size)``; only exactly-full pages are interned, so
    a sharer never writes a shared frame (its own tail starts on the
    next page boundary) and the KV inside is position-exact for every
    sharer (RoPE is absolute, prefixes share positions).
  * **The cache is a page-table sequence.**  Interned pages live under
    the pseudo-sequence :data:`PREFIX_SEQ` in the engine's own
    :class:`~repro_torch.paging.PageTable` — one logical page per entry
    — so the pager's LRU eviction, clean-park fast path and far-tier
    bookkeeping all apply to cache-owned frames with no special cases:
    under pool pressure a cache frame parks to the far tier for free
    (its far home is written at intern time) and a later hit fetches it
    back with a LATENCY aload.
  * **COW discipline.**  Interning sets the frame's copy-on-write bit;
    the refcount + :meth:`~repro_torch.paging.PageTable.remap_private`
    give writers an escape hatch.  On the supported families (global-
    attention dense/moe, append-only KV) no writer ever reaches a
    shared page — the engine still guards the decode tail defensively.
  * **Far hits fetch private copies.**  A hit on a parked entry installs
    the entry's host payload as the *requester's* far alias (no copy —
    same host array) and lets the ordinary resume machinery fetch it,
    so "prefix hit while the page is still ARRIVING" is just the
    existing resume-while-ARRIVING path.

This is the serving-level version of the paper's aggregation argument:
the far tier plus massive outstanding aloads turns recomputation into
cheap, overlappable transfers (2404.11044 §4's memory-pool economics).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional

import numpy as np

from repro_torch.paging.page_table import (NOT_MAPPED, PagePool,
                                           PageState, PageTable,
                                           PagingError)
from repro_torch.paging.pager import Pager

__all__ = ["PrefixCache", "PREFIX_SEQ", "page_hashes"]

#: Pseudo-sequence owning cache entries in the engine's page table.
PREFIX_SEQ = "~prefix"


def page_hashes(prompt: np.ndarray, page_size: int) -> List[bytes]:
    """Rolling hash per *full* page of ``prompt`` token ids.

    ``h[i]`` digests the entire prefix ``prompt[: (i+1) * page_size]``
    (chained, not per-page), so equal hashes imply equal full prefixes —
    a hit on page ``i`` is only meaningful after hits on ``0..i-1``.

    >>> a = page_hashes(np.arange(8, dtype=np.int32), 4)
    >>> b = page_hashes(np.arange(9, dtype=np.int32), 4)
    >>> a == b[:2] and len(b) == 2
    True
    """
    prompt = np.ascontiguousarray(prompt, dtype=np.int32)
    out: List[bytes] = []
    h = hashlib.blake2b(digest_size=16)
    for i in range(len(prompt) // page_size):
        h.update(prompt[i * page_size:(i + 1) * page_size].tobytes())
        out.append(h.copy().digest())
    return out


@dataclass
class _Entry:
    logical: int          # index in the PREFIX_SEQ page-table row
    hits: int = 0
    last_hit: int = 0


class PrefixCache:
    """Content-addressed store of computed prompt pages.

    Wraps the engine's pool/table/pager; entries are logical pages of
    the :data:`PREFIX_SEQ` pseudo-sequence.  ``match`` finds the
    longest usable shared prefix of a prompt; ``intern`` donates a
    just-prefilled request's full prompt pages.  Example::

        cache = PrefixCache(pool, table, pager, page_size=16)
        hits = cache.match(prompt)       # [(logical, phys-or-None), ...]
        ...                              # engine maps / fetches them
        cache.intern(prompt, rid, read_frame)   # after prefill finishes
    """

    def __init__(self, pool: PagePool, table: PageTable, pager: Pager,
                 page_size: int, max_pages: Optional[int] = None):
        self.pool = pool
        self.table = table
        self.pager = pager
        self.page_size = page_size
        self.max_pages = max_pages
        self._by_hash: Dict[bytes, _Entry] = {}
        self._clock = 0
        table.register(PREFIX_SEQ)
        # per-request hit/saved-token tallies live in the engine's stats
        self.stats = {"interned": 0, "evicted_entries": 0}

    # -- lookup --------------------------------------------------------------
    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest usable run of cached pages for ``prompt``.

        Returns the cache-entry *logical* indices for leading full pages
        ``0..k-1``, capped so at least the prompt's final token is left
        to compute (the chunk path must produce logits at ``plen - 1``
        to sample the first token, so a full-prompt hit recomputes its
        last page).
        """
        plen = len(prompt)
        max_pages = max(0, (plen - 1) // self.page_size)
        out: List[int] = []
        self._clock += 1
        for h in page_hashes(prompt, self.page_size)[:max_pages]:
            ent = self._by_hash.get(h)
            if ent is None:
                break
            ent.hits += 1
            ent.last_hit = self._clock
            out.append(ent.logical)
        return out

    def entry_state(self, logical: int) -> PageState:
        return self.table.entry(PREFIX_SEQ, logical).state

    def entry_phys(self, logical: int) -> int:
        return self.table.entry(PREFIX_SEQ, logical).phys

    def far_key(self, logical: int):
        return (PREFIX_SEQ, logical)

    # -- intern --------------------------------------------------------------
    def intern(self, prompt: np.ndarray, seq: Hashable, read_frame) -> int:
        """Donate a prefilled sequence's full prompt pages to the cache.

        For each full page of ``prompt`` not already cached: share the
        donor's frame into the :data:`PREFIX_SEQ` row (refcount up, COW
        bit on) and write the page's host payload to the far tier, so
        every future sharer can clean-park it and a cache eviction is
        free.  The donor keeps decoding on the same frame — it never
        writes it again (its tail lives on later pages).  Returns the
        number of pages newly interned.
        """
        new = 0
        hashes = page_hashes(prompt, self.page_size)
        for i, h in enumerate(hashes):
            ent = self._by_hash.get(h)
            if ent is not None:
                # entry exists but may have been evicted to the far tier:
                # re-promote it onto this sharer's freshly-fetched frame
                # (self-healing — the next hit is a device hit again)
                self._repromote(ent, seq, i)
                continue
            try:
                pte = self.table.entry(seq, i)
            except PagingError:
                break
            if pte.state is not PageState.RESIDENT or pte.phys == NOT_MAPPED:
                continue            # page already parked: nothing to share
            if self.max_pages is not None and \
                    len(self._by_hash) >= self.max_pages:
                self._evict_entry()
            logical = self.table.append_shared(PREFIX_SEQ, pte.phys)
            self.pool.mark_cow(pte.phys)
            self.pool.mark_dirty(pte.phys, False)
            self.pool.frames[pte.phys].tokens = self.page_size
            # far home written now: any sharer (and the cache itself)
            # can park this page clean, for free, forever after — the
            # donor included, via an alias under its own key
            payload = read_frame(pte.phys)
            self.pager.store_far(PREFIX_SEQ, logical, payload,
                                 tokens=self.page_size)
            self.pager.store_far(seq, i, payload, tokens=self.page_size)
            self._by_hash[h] = _Entry(logical=logical, last_hit=self._clock)
            self.stats["interned"] += 1
            new += 1
        return new

    def _repromote(self, ent: _Entry, seq: Hashable, logical: int) -> None:
        """Point a far-only cache entry back at a device frame a sharer
        just fetched/recomputed, so future hits are device hits."""
        pte_c = self.table.entry(PREFIX_SEQ, ent.logical)
        if pte_c.state is not PageState.PARKED:
            return
        try:
            pte_s = self.table.entry(seq, logical)
        except PagingError:
            return
        if pte_s.state is not PageState.RESIDENT or pte_s.phys == NOT_MAPPED:
            return
        self.pool.share(pte_s.phys, PREFIX_SEQ, ent.logical)
        self.pool.mark_cow(pte_s.phys)
        self.pool.mark_dirty(pte_s.phys, False)
        self.pool.frames[pte_s.phys].tokens = self.page_size
        pte_c.state = PageState.RESIDENT
        pte_c.phys = pte_s.phys

    # -- capacity ------------------------------------------------------------
    def _evict_entry(self) -> None:
        """Tombstone the least-recently-hit entry whose frame is not in
        use by any live sequence (refs == 1 means only the cache maps
        it).  Far copy and hash are dropped; the logical slot stays as
        an UNMAPPED tombstone (logical indices are positional)."""
        victims = sorted(self._by_hash.items(),
                         key=lambda kv: (kv[1].last_hit, kv[1].logical))
        for h, ent in victims:
            pte = self.table.entry(PREFIX_SEQ, ent.logical)
            if pte.state is PageState.RESIDENT:
                if self.pool.frames[pte.phys].refs > 1:
                    continue            # a live sequence still maps it
                self.table.unpin_page(PREFIX_SEQ, ent.logical)
                self.table.mark_parked(PREFIX_SEQ, ent.logical)
            pte.state = PageState.UNMAPPED
            pte.phys = NOT_MAPPED
            self.pager.tier.discard(self.far_key(ent.logical))
            del self._by_hash[h]
            self.stats["evicted_entries"] += 1
            return
        raise PagingError("prefix cache full and every entry is in use")
