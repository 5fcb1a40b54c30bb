"""Page tables over a fixed device page pool.

The paper's far-memory model applied at *page granularity*: instead of
moving one sequence's entire KV as a single AMU request (the coarse
blocking-transfer pattern §1 argues against), KV state is carved into
fixed-size pages of token positions.  A page is the unit of transfer,
residency and eviction — the central systems knob the memory-
disaggregation literature identifies.

Two objects:

  * :class:`PagePool` — the physical device pages (the near tier /
    SPM in paper terms).  A fixed number of frames, a free heap, and
    per-frame metadata: users, residency, dirty, pin/ref counts, COW
    bit, last-use tick.  Frames are reused without zeroing (a page's
    content is always fully overwritten by its next owner before being
    read).
  * :class:`PageTable` — per-sequence logical→physical maps.  Each
    entry is one page's *Access Pattern Register* worth of state: where
    the page lives (device frame / far tier / in flight) plus the
    residency bit the pager flips as ``getfin`` completions land.

Cross-request prefix sharing (``repro.paging.prefix_cache``) makes the
mapping many-to-one: a frame holding a content-addressed shared prompt
page is referenced by several sequences' PTEs at once.  The frame table
therefore carries a *reference count* (mappings), a *pin count* (active
slots among them) and a *copy-on-write bit* (set when a frame is
interned into the prefix cache; a sharer that would write it must break
the share first via :meth:`PageTable.remap_private`).  Releasing a
mapping only returns the frame to the free heap when the last reference
drops.

Mapping onto the paper's vocabulary: a page table entry's physical
frame id is what an APR base address would hold; the per-page
:class:`PageState` is the completion state machine that ``aload`` /
``astore`` / ``getfin`` drive; and the pool's free-frame watermarks are
what the event-driven scheduler (``repro_torch.paging.events``) consults in
place of the paper's free-SPM-slot counts.
"""

from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Set, Tuple

from repro_torch.core.amu import AMUError
from repro_torch.obs import NULL_TRACER

__all__ = ["PagingError", "PageState", "Frame", "PagePool", "PageTable",
           "NOT_MAPPED", "pages_for"]

#: Physical frame id meaning "no device frame backs this entry".
NOT_MAPPED: int = -1


class PagingError(AMUError):
    """Invalid paging-layer usage (double free, bad map, pool misuse)."""


class PageState(enum.Enum):
    UNMAPPED = "unmapped"    # never allocated (beyond the sequence's length)
    RESIDENT = "resident"    # device frame holds the page
    PARKED = "parked"        # far tier holds the page; no device frame
    ARRIVING = "arriving"    # aload in flight; device frame reserved


@dataclass
class Frame:
    """Per-physical-page metadata (the pool's frame table row).

    ``refs`` counts page-table mappings (plus the prefix cache's own
    mapping when the frame is interned); ``pins`` counts the mappings
    whose sequence is actively decoding/prefilling.  ``cow`` marks
    content-addressed shared frames: immutable while shared — a writer
    must break the share first.  ``users`` is the reverse map of the
    mappings (maintained by :class:`PageTable`), what lets the LRU
    evictor find the one mapping of a sole-owned frame.
    """

    phys: int
    refs: int = 0
    pins: int = 0
    cow: bool = False
    dirty: bool = False
    last_use: int = 0
    tokens: int = -1         # valid token positions in the frame, when known
    data: Any = None         # frame contents when not materialised elsewhere
    users: Set[Tuple[Hashable, int]] = field(default_factory=set)

    @property
    def pinned(self) -> bool:
        return self.pins > 0

    @property
    def owner(self) -> Optional[Hashable]:
        """Any one mapping's sequence (None when unmapped)."""
        return next(iter(self.users))[0] if self.users else None

    @property
    def logical(self) -> int:
        return next(iter(self.users))[1] if self.users else -1


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages covering ``n_tokens`` positions.

    >>> pages_for(17, 16)
    2
    >>> pages_for(0, 16)
    0
    """
    return -(-max(0, n_tokens) // page_size)


class PagePool:
    """Fixed pool of device page frames with a free heap.

    The near tier of the paper's two-tier model — what SPM is to the
    AMU core (§2.1), the device HBM page frames are to the serving
    engine.  The free list is a min-heap so allocation is O(log n) and
    frame ids are reused lowest-first (deterministic layouts for
    tests).  Example::

        pool = PagePool(n_pages=8, page_size=16)
        phys = pool.alloc(owner=rid, logical=0)
        pool.pin(phys)            # active slots pin their pages
        pool.unpin(phys); pool.free(phys)

    Frames are reference counted so the prefix cache can map one frame
    from several sequences: ``share`` adds a mapping, ``release`` drops
    one, and the frame returns to the free heap only when the last
    reference goes.  ``pin``/``unpin`` are counts for the same reason.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise PagingError("PagePool needs at least one page")
        if page_size < 1:
            raise PagingError("page_size must be >= 1 tokens")
        self.n_pages = n_pages
        self.page_size = page_size
        self.frames: List[Frame] = [Frame(phys=i) for i in range(n_pages)]
        self._free: List[int] = list(range(n_pages))
        heapq.heapify(self._free)
        self._allocated = [False] * n_pages
        self._use_seq = 0            # monotonic recency stamp for LRU

    # -- alloc/free ---------------------------------------------------------
    def alloc(self, owner: Hashable, logical: int) -> int:
        """Take a free frame for (owner, logical); raises when exhausted."""
        if not self._free:
            raise PagingError("page pool exhausted")
        phys = heapq.heappop(self._free)
        self._allocated[phys] = True
        f = self.frames[phys]
        f.refs, f.pins = 1, 0
        f.cow = f.dirty = False
        f.tokens = -1
        f.data = None
        f.users = {(owner, logical)}
        return phys

    def share(self, phys: int, owner: Hashable, logical: int) -> None:
        """Add a mapping to a live frame (prefix sharing)."""
        self._check_live(phys)
        f = self.frames[phys]
        f.refs += 1
        f.users.add((owner, logical))

    def release(self, phys: int, owner: Hashable, logical: int) -> None:
        """Drop one mapping; the frame frees when the last ref goes."""
        self._check_live(phys)
        f = self.frames[phys]
        if f.refs < 1:
            raise PagingError(f"release underflow on frame {phys}")
        if f.refs == 1 and f.pins:
            raise PagingError(f"cannot free pinned frame {phys}")
        f.refs -= 1
        f.users.discard((owner, logical))
        if f.refs == 0:
            f.cow = f.dirty = False
            f.data = None
            f.users = set()
            self._allocated[phys] = False
            heapq.heappush(self._free, phys)

    def free(self, phys: int) -> None:
        """Free a sole-owned frame (compat path; shared frames must go
        through :meth:`release` one mapping at a time)."""
        self._check(phys)
        if not self._allocated[phys]:
            raise PagingError(f"double free of frame {phys}")
        f = self.frames[phys]
        if f.refs > 1:
            raise PagingError(
                f"free of shared frame {phys} (refs={f.refs}); "
                "release each mapping instead")
        user = next(iter(f.users)) if f.users else (None, -1)
        self.release(phys, *user)

    # -- metadata -----------------------------------------------------------
    def pin(self, phys: int) -> None:
        self._check_live(phys)
        self.frames[phys].pins += 1

    def unpin(self, phys: int) -> None:
        self._check_live(phys)
        f = self.frames[phys]
        if f.pins < 1:
            raise PagingError(f"unpin underflow on frame {phys}")
        f.pins -= 1

    def touch(self, phys: int) -> None:
        """Stamp a frame as most-recently-used (internal monotonic
        counter, so pager completions and scheduler ticks share one
        recency order)."""
        self._check_live(phys)
        self._use_seq += 1
        self.frames[phys].last_use = self._use_seq

    def mark_dirty(self, phys: int, dirty: bool = True) -> None:
        self._check_live(phys)
        self.frames[phys].dirty = dirty

    def mark_cow(self, phys: int, cow: bool = True) -> None:
        """Flag a frame copy-on-write (set when the prefix cache interns
        it): sharers must not write it; see PageTable.remap_private."""
        self._check_live(phys)
        self.frames[phys].cow = cow

    def lru_victims(self, n: int) -> List[int]:
        """Up to ``n`` unpinned allocated frames, least-recently-used first."""
        live = [f for f in self.frames
                if self._allocated[f.phys] and not f.pinned]
        live.sort(key=lambda f: (f.last_use, f.phys))
        return [f.phys for f in live[:n]]

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def is_live(self, phys: int) -> bool:
        return 0 <= phys < self.n_pages and self._allocated[phys]

    def _check(self, phys: int) -> None:
        if not 0 <= phys < self.n_pages:
            raise PagingError(f"bad frame id {phys}")

    def _check_live(self, phys: int) -> None:
        self._check(phys)
        if not self._allocated[phys]:
            raise PagingError(f"frame {phys} is not allocated")


@dataclass
class PTE:
    """One logical page's entry: state + device frame when resident.

    ``pinned`` records whether *this mapping* holds one of the frame's
    pins — what lets ``drop`` unpin exactly the dropped sequence's share
    of a frame that other sequences still pin.
    """

    state: PageState = PageState.UNMAPPED
    phys: int = NOT_MAPPED
    pinned: bool = False


class PageTable:
    """Per-sequence logical→physical page maps over one :class:`PagePool`.

    Each entry is one page's Access-Pattern-Register's worth of state
    (§2.2): the frame id an APR base address would hold plus the
    :class:`PageState` residency bit that ``aload``/``astore``/
    ``getfin`` completions drive.  Example::

        table = PageTable(pool)
        table.register(rid)
        table.ensure_capacity(rid, n_tokens=33)   # -> [0, 1, 2] new pages
        table.entry(rid, 0).state                 # PageState.RESIDENT
        table.drop(rid)                           # frees every frame

    Prefix sharing appends *aliased* entries: ``append_shared`` maps a
    new sequence's next logical page onto an existing frame (refcount
    up, no allocation), ``append_parked`` starts it in the far tier.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._maps: Dict[Hashable, List[PTE]] = {}
        # bound by Pager.bind_obs: residency transitions emit one
        # instant each on the ("pager", "residency") track when tracing
        self.tracer = NULL_TRACER

    # -- sequence lifecycle --------------------------------------------------
    def register(self, seq: Hashable) -> None:
        if seq in self._maps:
            raise PagingError(f"sequence {seq!r} already registered")
        self._maps[seq] = []

    def register_parked(self, seq: Hashable, n_pages: int) -> None:
        """Register a sequence whose pages all start in the far tier
        (restore / cold-start path: no device frames are taken)."""
        self.register(seq)
        self._maps[seq] = [PTE(state=PageState.PARKED)
                           for _ in range(n_pages)]

    def drop(self, seq: Hashable) -> None:
        """Unregister a sequence, releasing every device frame mapping it
        holds — even pinned ones (drop is terminal for the sequence).  A
        shared frame survives for its other users, keeping their pins."""
        for logical, pte in enumerate(self._entries(seq)):
            if pte.phys != NOT_MAPPED:
                frame = self.pool.frames[pte.phys]
                if frame.refs == 1:
                    frame.pins = 0           # force: sole owner is leaving
                    pte.pinned = False
                self._unmap(seq, logical, pte)
        del self._maps[seq]

    def sequences(self) -> List[Hashable]:
        return list(self._maps)

    # -- growth --------------------------------------------------------------
    def ensure_capacity(self, seq: Hashable, n_tokens: int) -> List[int]:
        """Extend the map so ``n_tokens`` positions are covered by RESIDENT
        pages, allocating frames for any new logical pages.  Returns the
        list of newly-allocated logical page indices."""
        entries = self._entries(seq)
        need = pages_for(n_tokens, self.pool.page_size)
        new: List[int] = []
        while len(entries) < need:
            logical = len(entries)
            phys = self.pool.alloc(seq, logical)
            entries.append(PTE(state=PageState.RESIDENT, phys=phys))
            new.append(logical)
        return new

    def append_shared(self, seq: Hashable, phys: int) -> int:
        """Map ``seq``'s next logical page onto an existing frame
        (prefix hit on a device-resident shared page).  Returns the
        logical index.  The frame's refcount goes up; no allocation."""
        entries = self._entries(seq)
        logical = len(entries)
        self.pool.share(phys, seq, logical)
        entries.append(PTE(state=PageState.RESIDENT, phys=phys))
        return logical

    def append_parked(self, seq: Hashable) -> int:
        """Map ``seq``'s next logical page as far-tier resident (prefix
        hit on a parked shared page: the caller installs the far alias
        and the pager fetches a private copy).  Returns the logical."""
        entries = self._entries(seq)
        entries.append(PTE(state=PageState.PARKED))
        return len(entries) - 1

    def truncate(self, seq: Hashable, n_pages: int) -> None:
        """Drop trailing entries beyond ``n_pages``, releasing any frames
        they hold (growth pages that never received content)."""
        entries = self._entries(seq)
        while len(entries) > n_pages:
            logical = len(entries) - 1
            pte = entries.pop()
            if pte.phys != NOT_MAPPED:
                self._unmap(seq, logical, pte)

    def rewind_tokens(self, seq: Hashable, n_tokens: int) -> int:
        """Rewind ``seq``'s mapping to its first ``n_tokens`` valid
        positions, releasing every wholly-garbage trailing page — the
        page-table half of speculative rollback (the rejected draft
        tail past ``n_tokens`` becomes dead KV; pages that hold no live
        token at all go back to the pool, the partial tail page stays
        and is simply overwritten as the sequence appends).  Returns
        the number of pages released.

        Idempotent, and a no-op when the mapping already fits (the
        all-drafts-accepted case).  The freshness bookkeeping needs no
        touch-up here: a later park derives its per-page valid-token
        tag from the engine's rewound ``pos``, so a rolled-back park
        stays clean for free."""
        keep = pages_for(n_tokens, self.pool.page_size)
        dropped = len(self._entries(seq)) - keep
        if dropped > 0:
            self.truncate(seq, keep)
            return dropped
        return 0

    def pages_needed(self, seq_or_tokens, n_tokens: Optional[int] = None) -> int:
        """Additional frames required to cover ``n_tokens`` positions.
        Call as ``pages_needed(n_tokens)`` for an unregistered sequence."""
        if n_tokens is None:
            return pages_for(seq_or_tokens, self.pool.page_size)
        have = len(self._entries(seq_or_tokens))
        return max(0, pages_for(n_tokens, self.pool.page_size) - have)

    # -- entry access --------------------------------------------------------
    def entry(self, seq: Hashable, logical: int) -> PTE:
        entries = self._entries(seq)
        if not 0 <= logical < len(entries):
            raise PagingError(f"sequence {seq!r} has no logical page {logical}")
        return entries[logical]

    def n_pages(self, seq: Hashable) -> int:
        return len(self._entries(seq))

    def logical_pages(self, seq: Hashable, state: Optional[PageState] = None
                      ) -> List[int]:
        return [i for i, p in enumerate(self._entries(seq))
                if state is None or p.state is state]

    def resident(self, seq: Hashable) -> bool:
        """True iff every mapped page of ``seq`` is device-resident."""
        entries = self._entries(seq)
        return all(p.state is PageState.RESIDENT for p in entries)

    def shared(self, seq: Hashable, logical: int) -> bool:
        """True iff the page's frame is mapped by more than one user."""
        pte = self.entry(seq, logical)
        return (pte.phys != NOT_MAPPED
                and self.pool.frames[pte.phys].refs > 1)

    # -- pinning (mapping-level, so shared frames count correctly) -----------
    def pin_page(self, seq: Hashable, logical: int) -> None:
        pte = self.entry(seq, logical)
        if pte.phys == NOT_MAPPED:
            raise PagingError(f"pin of unmapped page ({seq!r}, {logical})")
        if not pte.pinned:
            self.pool.pin(pte.phys)
            pte.pinned = True

    def unpin_page(self, seq: Hashable, logical: int) -> None:
        pte = self.entry(seq, logical)
        if pte.pinned and pte.phys != NOT_MAPPED:
            self.pool.unpin(pte.phys)
        pte.pinned = False

    # -- state transitions (driven by the pager) -----------------------------
    def mark_parked(self, seq: Hashable, logical: int) -> int:
        """RESIDENT → PARKED; releases this mapping and returns the frame
        id (which frees only if no other sequence still maps it)."""
        pte = self.entry(seq, logical)
        if pte.state is not PageState.RESIDENT:
            raise PagingError(
                f"park of non-resident page ({seq!r}, {logical}): {pte.state}")
        phys = pte.phys
        self._unmap(seq, logical, pte)
        pte.phys = NOT_MAPPED
        pte.state = PageState.PARKED
        if self.tracer.enabled:
            self.tracer.instant("pager", "residency", "PARKED",
                                {"seq": seq, "logical": logical})
        return phys

    def mark_arriving(self, seq: Hashable, logical: int) -> int:
        """PARKED → ARRIVING; allocates and returns the reserved frame."""
        pte = self.entry(seq, logical)
        if pte.state is not PageState.PARKED:
            raise PagingError(
                f"fetch of non-parked page ({seq!r}, {logical}): {pte.state}")
        pte.phys = self.pool.alloc(seq, logical)
        pte.state = PageState.ARRIVING
        if self.tracer.enabled:
            self.tracer.instant("pager", "residency", "ARRIVING",
                                {"seq": seq, "logical": logical})
        return pte.phys

    def mark_resident(self, seq: Hashable, logical: int) -> None:
        """ARRIVING → RESIDENT (the page's residency bit; getfin landed)."""
        pte = self.entry(seq, logical)
        if pte.state is not PageState.ARRIVING:
            raise PagingError(
                f"arrival for page ({seq!r}, {logical}) in state {pte.state}")
        pte.state = PageState.RESIDENT
        if self.tracer.enabled:
            self.tracer.instant("pager", "residency", "RESIDENT",
                                {"seq": seq, "logical": logical})

    def remap_private(self, seq: Hashable, logical: int) -> Tuple[int, int]:
        """Break a COW share: allocate a private frame for this mapping
        and return ``(old_phys, new_phys)`` so the caller can copy the
        page's device content across.  The old frame keeps its other
        users.  No-op (returns ``(phys, phys)``) when already private."""
        pte = self.entry(seq, logical)
        if pte.state is not PageState.RESIDENT or pte.phys == NOT_MAPPED:
            raise PagingError(
                f"remap of non-resident page ({seq!r}, {logical})")
        old = pte.phys
        if self.pool.frames[old].refs <= 1:
            return old, old
        pinned = pte.pinned
        new = self.pool.alloc(seq, logical)
        if pinned:
            self.pool.unpin(old)
            self.pool.pin(new)
        self.pool.release(old, seq, logical)
        pte.phys = new
        return old, new

    # -- internals -----------------------------------------------------------
    def _unmap(self, seq: Hashable, logical: int, pte: PTE) -> None:
        """Release one mapping's pin (if held) and reference."""
        if pte.pinned:
            self.pool.unpin(pte.phys)
            pte.pinned = False
        self.pool.release(pte.phys, seq, logical)

    def _entries(self, seq: Hashable) -> List[PTE]:
        if seq not in self._maps:
            raise PagingError(f"unknown sequence {seq!r}")
        return self._maps[seq]
