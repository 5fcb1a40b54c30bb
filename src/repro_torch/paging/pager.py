"""AMU-backed demand/prefetch pager over the device page pool.

The pager is the traffic engine between the pool (near tier) and the
host far tier — a :class:`repro_torch.core.offload.FarMemoryTier`, the single
storage backend every cold page (preempted, evicted or finished) lives
in — expressed entirely as the paper's instruction set against
:class:`repro_torch.core.amu.AMU`:

  * **prefetch** — LATENCY-QoS ``aload`` of the next-needed pages,
    issued while the current decode step computes, so the far-memory
    latency hides behind useful work (the paper's MACR: a small
    granularity + high priority for latency-critical random access),
  * **writeback / eviction** — BULK-QoS ``astore`` of cold or evicted
    pages under an LRU-with-pinning policy (pinned frames back active
    decode slots and are never victims),
  * **poll** — ``getfin``: non-blocking completion drain that flips the
    page table's residency bits and never stalls the event loop.

On top of the AMU's global outstanding-slot queue the pager adds
*per-QoS outstanding windows*: each class gets its own bounded window
so BULK writeback can never occupy every hardware queue entry ahead of
a latency-critical fetch — the QoS field of the paper's Memory Access
Configuration Register enforced at the issue stage.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Deque, Dict, Hashable, List, Optional, Tuple

from repro_torch.core.amu import (AMU, AMUError, AccessConfig, FAILURE_CODE, QoS,
                            RequestState, SimBackend)
from repro_torch.core.offload import FarMemoryTier
from repro_torch.obs import MetricsRegistry, NULL_TRACER
from repro_torch.paging.page_table import (NOT_MAPPED, PagePool, PageState,
                                     PageTable, PagingError)

__all__ = ["Pager", "QoSWindows"]

#: per-QoS take/release counter keys (precomputed: no per-op f-strings)
_TAKE_KEY = {q: f"window_take_{q.name.lower()}" for q in QoS}
_RELEASE_KEY = {q: f"window_release_{q.name.lower()}" for q in QoS}
_OCCUPANCY_TRACK = {q: f"window/{q.name}" for q in QoS}
#: per-QoS transferred-byte counters: every submitted aload/astore adds
#: its page_nbytes, so a quantized pool's smaller frames show up
#: directly as fewer bytes moved per class (tools/trace_report.py turns
#: these into per-QoS bytes/s)
_BYTES_KEY = {q: f"bytes_moved_{q.name.lower()}" for q in QoS}

_PENDING = -2        # rid sentinel: request queued behind its QoS window


class QoSWindows:
    """Per-QoS outstanding-request windows layered over one AMU queue.

    The QoS field of the paper's Memory Access Configuration Register
    (§2.2) enforced at the issue stage: each class gets its own bounded
    window, so BULK writeback can never occupy every hardware queue
    entry ahead of a latency-critical fetch.  Example::

        w = QoSWindows({QoS.LATENCY: 16, QoS.BULK: 4})
        if w.has_room(QoS.BULK):
            w.take(QoS.BULK)      # ... issue the astore ...
        w.release(QoS.BULK)       # on getfin completion
    """

    def __init__(self, windows: Dict[QoS, int]):
        for q, w in windows.items():
            if w < 1:
                raise PagingError(f"QoS window for {q.name} must be >= 1")
        self.limit = dict(windows)
        self.in_flight: Dict[QoS, int] = {q: 0 for q in windows}
        # every take/release is counted (the acquire/release balance
        # invariant reads these) and sampled onto one occupancy counter
        # track per class when tracing is on
        self.stats = MetricsRegistry().counters("pager")
        self.tracer = NULL_TRACER

    def bind_obs(self, stats, tracer) -> None:
        """Point take/release accounting at a shared registry view +
        tracer (existing counts carry over)."""
        if stats is not self.stats:
            for k, v in self.stats.items():
                stats[k] += v
            self.stats = stats
        self.tracer = tracer

    def has_room(self, qos: QoS) -> bool:
        return self.in_flight[qos] < self.limit[qos]

    def take(self, qos: QoS) -> None:
        if not self.has_room(qos):
            raise PagingError(f"QoS window {qos.name} full")
        self.in_flight[qos] += 1
        self.stats[_TAKE_KEY[qos]] += 1
        if self.tracer.enabled:
            self.tracer.counter("pager", _OCCUPANCY_TRACK[qos],
                                self.in_flight[qos])

    def release(self, qos: QoS) -> None:
        if self.in_flight[qos] <= 0:
            raise PagingError(f"QoS window {qos.name} release underflow")
        self.in_flight[qos] -= 1
        self.stats[_RELEASE_KEY[qos]] += 1
        if self.tracer.enabled:
            self.tracer.counter("pager", _OCCUPANCY_TRACK[qos],
                                self.in_flight[qos])

    def check_invariants(self) -> None:
        """Take/release counters must balance against live occupancy."""
        for qos, limit in self.limit.items():
            occ = self.in_flight[qos]
            if not 0 <= occ <= limit:
                raise PagingError(
                    f"QoS window {qos.name} occupancy {occ} outside "
                    f"[0, {limit}]")
            takes = self.stats[_TAKE_KEY[qos]]
            releases = self.stats[_RELEASE_KEY[qos]]
            if takes - releases != occ:
                raise PagingError(
                    f"QoS window {qos.name} unbalanced: {takes} takes - "
                    f"{releases} releases != {occ} in flight")


class Pager:
    """Demand/prefetch pager: moves pages between pool frames and the
    far tier through LATENCY aloads and BULK astores (§2.2 ISA, §2.3
    QoS split).  Example — park two pages, bring them back overlapped::

        pager.writeback(rid, 0, payload0)     # BULK astore (dirty)
        pager.park_clean(rid, 1)              # far copy current: free
        pager.prefetch_seq(rid, tail_first=True)   # LATENCY aloads
        for seq, logical in pager.poll():          # getfin drain
            ...                                    # residency bits set
    """

    def __init__(
        self,
        pool: PagePool,
        table: PageTable,
        amu: Optional[AMU] = None,
        *,
        page_nbytes: int = 1 << 16,
        latency_window: int = 16,
        standard_window: int = 8,
        bulk_window: int = 4,
        granularity: Optional[int] = None,
        read_frame: Optional[Callable[[int], Any]] = None,
        tier: Optional[FarMemoryTier] = None,
        tracer=None,
        metrics=None,
    ):
        self.pool = pool
        self.table = table
        # Optional hook: read a frame's content out of the device pool.
        # When the engine keeps page payloads in device arrays rather
        # than per-frame host copies, ``Frame.data`` is None and this is
        # how eviction obtains the writeback payload.
        self.read_frame = read_frame
        self.amu = amu or AMU(max_outstanding=latency_window
                              + standard_window + bulk_window)
        self.page_nbytes = int(page_nbytes)
        g = granularity or self.page_nbytes
        self.fetch_config = AccessConfig(granularity_bytes=g, qos=QoS.LATENCY)
        self.evict_config = AccessConfig(granularity_bytes=g, qos=QoS.BULK)
        self.windows = QoSWindows({QoS.LATENCY: latency_window,
                                   QoS.STANDARD: standard_window,
                                   QoS.BULK: bulk_window})
        # THE far tier: home copies of every cold page (and, for the
        # serving engine, finished-sequence KV + aux residues) live in
        # one FarMemoryTier sharing this pager's AMU.  The pager issues
        # its own windowed aloads/astores against the tier's storage;
        # completions consumed by either party on the shared queue are
        # forwarded to the other (see poll / _finish / _reap_failed).
        self.tier = tier if tier is not None else FarMemoryTier(self.amu)
        # in-flight request -> (kind, seq, logical, qos): the QoS class
        # travels *with* the request instead of being re-derived from
        # the kind string, so per-request overrides (the scheduler's
        # tier -> QoS mapping) release the right window on completion
        self._inflight: Dict[int, Tuple[str, Hashable, int, QoS]] = {}
        self._page_rid: Dict[Tuple[Hashable, int], int] = {}
        self._pending: Dict[QoS, Deque[Tuple[str, Hashable, int,
                                             Callable[[], int], float]]] = {
            QoS.LATENCY: collections.deque(),
            QoS.STANDARD: collections.deque(),
            QoS.BULK: collections.deque(),
        }
        # telemetry: stats is a Counter-compatible view onto a shared
        # MetricsRegistry (repro_torch.obs) — every existing stats["key"] call
        # site works unchanged, and one metrics export sees everything
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = self.metrics.counters("pager")
        self.tracer = NULL_TRACER
        self._noframe_t: Dict[Tuple[Hashable, int], float] = {}
        self._blocked_note: Dict[Tuple[Hashable, int], float] = {}
        self.bind_obs(self.metrics, tracer)

    def bind_obs(self, metrics=None, tracer=None) -> None:
        """Bind this pager (and its AMU, windows, page table) to a shared
        registry + tracer — the engine calls this so factory-built pagers
        land on the engine's clock/registry.  Existing counts migrate."""
        if metrics is not None and metrics is not self.metrics:
            fresh = metrics.counters("pager")
            for k, v in self.stats.items():
                fresh[k] += v
            self.metrics = metrics
            self.stats = fresh
        if tracer is not None:
            self.tracer = tracer
            self.amu.tracer = tracer
            self.table.tracer = tracer
        if self.amu.metrics is None or metrics is not None:
            self.amu.metrics = self.metrics
        self.windows.bind_obs(self.stats, self.tracer)

    def _now(self) -> float:
        return self.amu._clock()

    def check_invariants(self) -> None:
        """Window acquire/release accounting must balance: counter
        deltas equal live occupancy, and occupancy equals the number of
        requests this pager is actually tracking in flight."""
        self.windows.check_invariants()
        occ = sum(self.windows.in_flight.values())
        if occ != len(self._inflight):
            raise PagingError(
                f"window occupancy {occ} != {len(self._inflight)} "
                "tracked in-flight requests")

    # -- write path: park / writeback ---------------------------------------
    def writeback(self, seq: Hashable, logical: int, data: Any,
                  tokens: int = -1, qos: Optional[QoS] = None) -> None:
        """Park one RESIDENT page: the far tier becomes its home (an
        astore models the transfer — BULK by default, overridable per
        call for e.g. an interactive-tier preemption whose pages should
        not queue behind batch-tier parks), and this mapping's device
        frame is released.  ``tokens`` tags how many positions of the
        page were valid when stored, so a later park can tell a current
        far copy from a stale one (clean-eviction fast path)."""
        qos = QoS.BULK if qos is None else QoS(qos)
        self.table.mark_parked(seq, logical)
        self.tier.put((seq, logical), data, nbytes=self.page_nbytes,
                      tokens=tokens)
        self.stats["writeback"] += 1
        if self.tracer.enabled:
            self.tracer.instant("pager", "actions", "writeback",
                                {"seq": seq, "logical": logical,
                                 "qos": qos.name})
        self._issue(qos, "astore", seq, logical,
                    lambda: self.amu.astore(data, nbytes=self.page_nbytes,
                                            config=self.evict_config,
                                            qos=qos))

    def park_clean(self, seq: Hashable, logical: int) -> None:
        """Park a page whose far-tier home copy is already current —
        no astore traffic (the clean-eviction fast path)."""
        if (seq, logical) not in self.tier:
            raise PagingError(
                f"page ({seq!r}, {logical}) has no far-tier copy; "
                "use writeback for dirty pages")
        self.table.mark_parked(seq, logical)
        self.stats["clean_evict"] += 1
        if self.tracer.enabled:
            self.tracer.instant("pager", "actions", "clean_evict",
                                {"seq": seq, "logical": logical})

    def evict(self, seq: Hashable, logical: int,
              qos: Optional[QoS] = None) -> None:
        """Evict one resident page: writeback (BULK unless overridden)
        when its frame is dirty, frame free only when clean."""
        pte = self.table.entry(seq, logical)
        if pte.state is not PageState.RESIDENT:
            raise PagingError(
                f"evict of non-resident page ({seq!r}, {logical})")
        frame = self.pool.frames[pte.phys]
        if frame.dirty or (seq, logical) not in self.tier:
            data = frame.data
            if data is None and self.read_frame is not None:
                data = self.read_frame(pte.phys)
            # carry the frame's valid-token tag into the far entry so a
            # later park of the same content still hits the clean fast
            # path (an untagged writeback would poison it forever)
            self.writeback(seq, logical, data, tokens=frame.tokens, qos=qos)
        else:
            self.park_clean(seq, logical)
        self.stats["evictions"] += 1

    def evict_lru(self, n: int) -> int:
        """Evict up to ``n`` unpinned RESIDENT frames, least-recently-used
        first (ARRIVING frames have a fetch in flight and are skipped;
        so are frames mapped by more than one sequence — evicting one
        sharer's mapping cannot free the frame).  Returns how many were
        actually evicted."""
        done = 0
        for phys in self.pool.lru_victims(self.pool.n_pages):
            if done >= n:
                break
            f = self.pool.frames[phys]
            if f.refs > 1 or not f.users:
                continue
            seq, logical = next(iter(f.users))
            if self.table.entry(seq, logical).state \
                    is not PageState.RESIDENT:
                continue
            self.evict(seq, logical)
            done += 1
        return done

    def balance(self, low_free: int) -> int:
        """The capacity-pressure loop: evict LRU frames until at least
        ``low_free`` frames are free (§2.3.2 free-watermark policy made
        proactive — cold RESIDENT pages flow to the far tier *before*
        growth/admission hits an empty free heap, so the astores overlap
        decode instead of serialising in front of it).  Returns how many
        frames were evicted."""
        deficit = low_free - self.pool.n_free
        if deficit <= 0:
            return 0
        done = self.evict_lru(deficit)
        if done:
            self.stats["watermark_evictions"] += done
            if self.tracer.enabled:
                self.tracer.instant("pager", "actions", "watermark_evict",
                                    {"n": done, "free": self.pool.n_free})
        return done

    # -- read path: prefetch / demand fetch ---------------------------------
    def prefetch(self, seq: Hashable, logical: int,
                 qos: Optional[QoS] = None) -> bool:
        """Begin an aload of one PARKED page (non-blocking; LATENCY by
        default — the scheduler demotes batch-tier resumes to STANDARD
        so they cannot crowd interactive fetches out of the window).
        Returns False when the page is already resident or in flight."""
        qos = QoS.LATENCY if qos is None else QoS(qos)
        pte = self.table.entry(seq, logical)
        if pte.state in (PageState.RESIDENT, PageState.ARRIVING):
            return False
        if self.pool.n_free == 0:
            self.stats["prefetch_no_frame"] += 1
            if self.tracer.enabled:
                # first time this page is frame-blocked: remember when,
                # so the eventual fetch span carries the blocked time
                self._noframe_t.setdefault((seq, logical), self._now())
                self.tracer.instant("pager", "actions", "prefetch_no_frame",
                                    {"seq": seq, "logical": logical})
            return False
        self.table.mark_arriving(seq, logical)
        src = self.tier.home((seq, logical))
        self.stats["prefetch"] += 1
        if self.tracer.enabled:
            t_blocked = self._noframe_t.pop((seq, logical), None)
            if t_blocked is not None:
                self._blocked_note[(seq, logical)] = \
                    (self._now() - t_blocked) * 1e6
            self.tracer.instant("pager", "actions", "prefetch",
                                {"seq": seq, "logical": logical,
                                 "qos": qos.name})
        self._issue(qos, "aload", seq, logical,
                    lambda: self.amu.aload(src, nbytes=self.page_nbytes,
                                           config=self.fetch_config,
                                           qos=qos))
        return True

    def prefetch_seq(self, seq: Hashable, *, tail_first: bool = True,
                     qos: Optional[QoS] = None) -> int:
        """Prefetch every parked page of ``seq``; with ``tail_first`` the
        hot tail (most recent positions) is issued — and so arrives —
        first, which is the order a rescheduled decode touches them."""
        parked = self.table.logical_pages(seq, PageState.PARKED)
        if tail_first:
            parked = parked[::-1]
        n = 0
        for logical in parked:
            n += bool(self.prefetch(seq, logical, qos=qos))
        return n

    def poll(self) -> List[Tuple[Hashable, int]]:
        """getfin until the completion queue is empty; returns the pages
        whose aloads landed this call (residency bits now set).

        A *failed* request (``getfin`` raising :class:`AMUError`) must
        not leak its QoS window slot: the failure is reaped — window
        released, an aload's ARRIVING page reverted to PARKED so a
        retry can re-issue it — and polling continues.  Without this a
        single fault would permanently shrink the window until the
        class wedged entirely."""
        arrived: List[Tuple[Hashable, int]] = []
        while True:
            try:
                rid = self.amu.getfin()
            except AMUError:
                self._reap_failed()
                continue
            if rid == FAILURE_CODE:
                break
            got = self._finish(rid)
            if got is not None:
                arrived.append(got)
        self._pump()
        return arrived

    def _reap_failed(self) -> None:
        """Clean up every tracked request the AMU marked FAILED (and let
        the shared far tier reap its own failed fetches — one completion
        queue, two consumers)."""
        for rid in list(self._inflight):
            if self.amu.request(rid).state is RequestState.FAILED:
                self._fail_one(rid)
        if self.tier.amu is self.amu:
            self.tier._reap_failed()
        self._pump()

    def _fail_one(self, rid: int) -> None:
        """Undo one failed request's bookkeeping: release its QoS window
        slot and, for an aload, free the reserved frame and mark the
        page PARKED again (the far copy is still intact, so a later
        prefetch simply retries)."""
        kind, seq, logical, qos = self._inflight.pop(rid)
        self.windows.release(qos)
        self.stats[f"{kind}_failed"] += 1
        if self.tracer.enabled:
            self.tracer.instant("pager", "actions", "fault",
                                {"seq": seq, "logical": logical,
                                 "kind": kind, "qos": qos.name})
        if kind != "aload":
            return
        self._page_rid.pop((seq, logical), None)
        try:
            pte = self.table.entry(seq, logical)
        except PagingError:
            return                        # sequence dropped mid-flight
        if pte.state is PageState.ARRIVING:
            phys, pte.phys = pte.phys, NOT_MAPPED
            pte.state = PageState.PARKED
            self.pool.free(phys)

    def wait_page(self, seq: Hashable, logical: int) -> None:
        """Blocking: ensure one page is RESIDENT (demand fetch)."""
        pte = self.table.entry(seq, logical)
        if pte.state is PageState.RESIDENT:
            return
        if pte.state is PageState.PARKED:
            if self.pool.n_free == 0 and not self.evict_lru(1):
                raise PagingError(
                    f"demand fetch of ({seq!r}, {logical}): pool "
                    "exhausted and nothing evictable")
            if not self.prefetch(seq, logical):
                raise PagingError(
                    f"demand fetch of ({seq!r}, {logical}) failed to issue")
            self.stats["demand_fetch"] += 1
            if self.tracer.enabled:
                self.tracer.instant("pager", "actions", "demand_fetch",
                                    {"seq": seq, "logical": logical})
        rid = self._page_rid.get((seq, logical), _PENDING)
        if rid == _PENDING:
            self._force_issue(seq, logical)
            rid = self._page_rid[(seq, logical)]
        req = self.amu.wait(rid)
        if req.error is not None:
            if rid in self._inflight:
                self._fail_one(rid)
            self._pump()
            raise PagingError(
                f"demand fetch of ({seq!r}, {logical}) failed"
            ) from req.error
        self._finish(rid)

    def wait_arriving(self, seq: Hashable) -> None:
        """Blocking: land every ARRIVING page of ``seq`` (no new frames
        are taken — safe under pool pressure)."""
        for logical in self.table.logical_pages(seq, PageState.ARRIVING):
            self.wait_page(seq, logical)

    def wait_seq(self, seq: Hashable) -> None:
        """Blocking: ensure every page of ``seq`` is RESIDENT.  Parked
        pages are all issued before the first wait so their transfers
        overlap each other (never one-fetch-at-a-time)."""
        self.prefetch_seq(seq, tail_first=False)
        for logical in range(self.table.n_pages(seq)):
            self.wait_page(seq, logical)

    def fetch_keys(self, keys: List[Hashable], *,
                   discard_after: bool = False) -> Dict[Hashable, Any]:
        """Overlapped fault-safe fetch of raw far-tier entries (the
        tier-payload analogue of :meth:`prefetch_seq` + :meth:`wait_seq`
        for pages): every key's aload is issued before the first wait so
        the transfers overlap, then each is verified landed.

        The one fault discipline both reuse paths share — the engine's
        ``fetch_finished`` reassembly and the cross-engine handoff
        admission: a mid-transfer :class:`~repro_torch.core.amu.AMUError`
        propagates with every home copy *intact* (``FarMemoryTier.get``
        clears only the pending transfer), so the caller retries by
        calling again; with ``discard_after`` the entries are dropped
        only once **all** payloads verifiably landed — never before."""
        tier = self.tier
        for key in keys:
            tier.prefetch(key)              # issue everything first
        out: Dict[Hashable, Any] = {}
        for key in keys:
            out[key] = tier.get(key)        # raises on fault; nothing
        if discard_after:                   # discarded yet
            for key in keys:
                tier.discard(key)
        return out

    # -- far-tier access (delegates to the shared FarMemoryTier) -------------
    def far_copy(self, seq: Hashable, logical: int) -> Any:
        return self.tier.home((seq, logical))

    def has_far(self, seq: Hashable, logical: int) -> bool:
        return (seq, logical) in self.tier

    def far_tokens(self, seq: Hashable, logical: int) -> int:
        """Valid-token tag of the far copy (-1: none or untagged)."""
        return self.tier.tokens_of((seq, logical))

    def store_far(self, seq: Hashable, logical: int, data: Any,
                  tokens: int = -1) -> None:
        self.tier.put((seq, logical), data, nbytes=self.page_nbytes,
                      tokens=tokens)

    def drop_far(self, seq: Hashable) -> None:
        self.tier.discard_seq(seq)
        for key in [k for k in self._page_rid if k[0] == seq]:
            del self._page_rid[key]

    def advance(self, dt: float) -> List[Tuple[Hashable, int]]:
        """Advance a simulated backend's clock by ``dt`` and poll.  On a
        real backend this is just a poll (time advances by itself)."""
        if isinstance(self.amu.backend, SimBackend):
            self.amu.backend.advance(dt)
        arrived = self.poll()
        if self.tracer.enabled:
            self.tracer.counter("pager", "free_frames", self.pool.n_free)
        return arrived

    # -- issue machinery -----------------------------------------------------
    def _issue(self, qos: QoS, kind: str, seq: Hashable, logical: int,
               submit: Callable[[], int]) -> None:
        if self.windows.has_room(qos):
            self.windows.take(qos)
            rid = submit()
            self._track(rid, kind, seq, logical, qos)
        else:
            self.stats["window_queued"] += 1
            if kind == "aload":
                self._page_rid[(seq, logical)] = _PENDING
            self._pending[qos].append((kind, seq, logical, submit,
                                       self._now()))
            if self.tracer.enabled:
                self.tracer.instant("pager", "actions", "window_queued",
                                    {"seq": seq, "logical": logical,
                                     "kind": kind, "qos": qos.name})

    def _track(self, rid: int, kind: str, seq: Hashable, logical: int,
               qos: QoS, queued_t: Optional[float] = None) -> None:
        self._inflight[rid] = (kind, seq, logical, qos)
        # counted at submit time (every _issue/_pump/_force_issue lands
        # here), so window-queued requests count once, when they move
        self.stats[_BYTES_KEY[qos]] += self.page_nbytes
        if kind == "aload":
            self._page_rid[(seq, logical)] = rid
        if self.tracer.enabled:
            note = {"seq": str(seq), "logical": logical}
            if queued_t is not None:
                note["window_wait_us"] = (self._now() - queued_t) * 1e6
            blocked = self._blocked_note.pop((seq, logical), None)
            if blocked is not None:
                note["frame_blocked_us"] = blocked
            self.amu.annotate(rid, **note)

    def _pump(self) -> None:
        # latency class drains first, bulk last (§2.2 QoS-ordered issue)
        for qos in (QoS.LATENCY, QoS.STANDARD, QoS.BULK):
            dq = self._pending[qos]
            while dq and self.windows.has_room(qos):
                kind, seq, logical, submit, t_q = dq.popleft()
                self.windows.take(qos)
                rid = submit()
                self._track(rid, kind, seq, logical, qos, queued_t=t_q)

    def _force_issue(self, seq: Hashable, logical: int) -> None:
        for qos, dq in self._pending.items():
            for i, (kind, s, l, submit, t_q) in enumerate(dq):
                if (s, l) == (seq, logical):
                    del dq[i]
                    while not self.windows.has_room(qos):
                        self._drain_one(qos)
                    self.windows.take(qos)
                    rid = submit()
                    self._track(rid, kind, seq, logical, qos, queued_t=t_q)
                    return
        raise PagingError(f"page ({seq!r}, {logical}) not pending")

    def _drain_one(self, qos: QoS) -> None:
        """Make room in a full window by finishing one of its requests.
        A drained request that *failed* is reaped like any other fault —
        window released, ARRIVING page reverted — never treated as a
        successful arrival."""
        for rid, (kind, _, _, q) in list(self._inflight.items()):
            if q is qos:
                req = self.amu.wait(rid)
                if req.error is not None:
                    self._fail_one(rid)
                else:
                    self._finish(rid)
                return
        raise PagingError(f"QoS window {qos.name} full with nothing in flight")

    def _finish(self, rid: int) -> Optional[Tuple[Hashable, int]]:
        """Bookkeeping for one consumed completion id."""
        entry = self._inflight.pop(rid, None)
        if entry is None:
            # foreign request on the shared AMU: forward it to the far
            # tier so its fetch bookkeeping sees the completion too
            if self.tier.amu is self.amu:
                self.tier.complete_rid(rid, self.amu.request(rid).payload)
            return None
        kind, seq, logical, qos = entry
        self.windows.release(qos)
        self._pump()
        if kind != "aload":
            return None
        self._page_rid.pop((seq, logical), None)
        # The sequence may have been dropped while its fetch was in flight.
        try:
            pte = self.table.entry(seq, logical)
        except PagingError:
            return None
        if pte.state is PageState.ARRIVING:
            frame = self.pool.frames[pte.phys]
            frame.data = self.tier.home((seq, logical))
            frame.dirty = False
            frame.tokens = self.tier.tokens_of((seq, logical))
            self.table.mark_resident(seq, logical)
            self.pool.touch(pte.phys)
            self.stats["arrived"] += 1
            if self.tracer.enabled:
                self.tracer.instant("pager", "actions", "arrived",
                                    {"seq": seq, "logical": logical})
            return (seq, logical)
        return None
