"""Far-memory tier manager built on the AMU runtime.

THE host far tier of the two-tier KV hierarchy (and the general
key→tensor offload store).  Production use-cases, all driven through
one :class:`FarMemoryTier`:

  * paged-KV far tier — *every* cold KV page of the serving engine
    (preempted, evicted or finished) is a page-granularity resident
    here; the :class:`~repro_torch.paging.Pager` is the traffic engine that
    moves pages in and out with LATENCY aloads / BULK astores under
    per-QoS windows, while this class is the single storage backend
    (``put``/``home``/``discard``) plus the off-hot-path fetch API the
    finished-sequence reuse path reads through,
  * optimizer-state offload — ZeRO-offload style: Adam moments live in
    the far tier (host DRAM) and stream in/out around the update,
  * parameter streaming — for models larger than HBM (llama4-maverick
    400B on one pod), layer blocks are aload-ed ``prefetch_depth``
    layers ahead of use, the paper's stream pattern at tensor
    granularity.

Everything is expressed as aload/astore + getfin against an :class:`AMU`,
so tests can swap in the simulated backend and assert overlap behaviour
deterministically.  Fetches are fault-safe: a failed aload never loses
the home copy — the entry stays fetchable and a retry re-issues.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from .amu import AMU, AMUError, AccessConfig, QoS, FAILURE_CODE

__all__ = ["FarMemoryTier", "StreamingPrefetcher", "OffloadedBuffer"]


def _tree_nbytes(value: Any) -> int:
    """Total bytes of an array, pytree of arrays, or None (0)."""
    if value is None:
        return 0
    if isinstance(value, dict):
        return sum(_tree_nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_tree_nbytes(v) for v in value)
    return int(getattr(value, "nbytes", np.asarray(value).nbytes))


@dataclass
class OffloadedBuffer:
    """A named tensor (or pytree) whose home is the far tier."""

    key: Hashable
    home: Any                   # array in far memory (host tier)
    nbytes: int
    resident: Any = None        # near-tier copy when fetched
    pending_rid: int = FAILURE_CODE
    tokens: int = -1            # payload-defined freshness tag (KV pages:
                                # valid token positions when stored)


class FarMemoryTier:
    """Key→tensor store in far memory with async fetch/evict via the AMU.

    One instance is the single far-tier backend for a serving engine:
    the pager parks pages into it (``put`` + its own windowed astores),
    prefetches out of it (``home`` + windowed aloads), and the
    finished-sequence path reads it with the ``prefetch``/``get`` API
    below (QoS-prioritised by the AMU's issue queue).  ``store_qos`` /
    ``fetch_qos`` are the §2.2 MACR QoS classes stamped on each
    direction: BULK writeback must never outrank a LATENCY fetch.
    """

    def __init__(self, amu: Optional[AMU] = None,
                 fetch_qos: QoS = QoS.LATENCY,
                 store_qos: QoS = QoS.BULK) -> None:
        self.amu = amu or AMU()
        self.fetch_config = AccessConfig(granularity_bytes=1 << 20,
                                         qos=fetch_qos)
        self.store_config = AccessConfig(granularity_bytes=1 << 20,
                                         qos=store_qos)
        self._store: Dict[Hashable, OffloadedBuffer] = {}
        self._rid_to_key: Dict[int, Hashable] = {}
        self.stats = collections.Counter()

    # -- write path ---------------------------------------------------------
    def put(self, key: Hashable, value: Any, *, nbytes: Optional[int] = None,
            tokens: int = -1) -> None:
        """Install ``value`` as ``key``'s home copy with *no* transfer
        traffic — the storage half of a transfer someone else models
        (the pager's windowed astores), or an alias of an existing host
        payload (shared prefix pages).  ``tokens`` is an optional
        freshness tag (for KV pages: valid positions when stored) that
        :meth:`tokens_of` reports back, letting the engine tell a
        current far copy from a stale one without content hashing."""
        self._store[key] = OffloadedBuffer(
            key=key, home=value,
            nbytes=_tree_nbytes(value) if nbytes is None else int(nbytes),
            tokens=tokens)
        self.stats["put"] += 1

    def offload(self, key: Hashable, value: Any, *, async_: bool = True,
                tokens: int = -1) -> int:
        """astore ``value`` into the far tier under ``key`` (BULK QoS)."""
        buf = OffloadedBuffer(key=key, home=value, nbytes=_tree_nbytes(value),
                              tokens=tokens)
        self._store[key] = buf
        rid = self.amu.astore(value, nbytes=max(1, buf.nbytes),
                              config=self.store_config)
        self.stats["offload"] += 1
        if not async_:
            self.amu.wait(rid)
            buf.home = self.amu.result(rid)
        return rid

    # -- storage bookkeeping -------------------------------------------------
    def home(self, key: Hashable) -> Any:
        """The far-tier home copy (no transfer; the pager's aloads model
        the device-bound traffic for pages read this way)."""
        return self._require(key).home

    def tokens_of(self, key: Hashable) -> int:
        """The freshness tag ``put``/``offload`` stored (-1 = untagged)."""
        buf = self._store.get(key)
        return -1 if buf is None else buf.tokens

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    def discard(self, key: Hashable) -> None:
        """Forget one entry (frees the far copy; no transfer)."""
        buf = self._store.pop(key, None)
        if buf is not None and buf.pending_rid != FAILURE_CODE:
            self._rid_to_key.pop(buf.pending_rid, None)

    def discard_seq(self, seq: Hashable) -> None:
        """Forget every ``(seq, logical)`` entry of one sequence."""
        for key in [k for k in self._store
                    if isinstance(k, tuple) and k and k[0] == seq]:
            self.discard(key)

    def far_bytes(self) -> int:
        return sum(b.nbytes for b in self._store.values())

    # -- read path ------------------------------------------------------------
    def prefetch(self, key: Hashable) -> int:
        """Issue an aload for ``key``; returns the request id (non-blocking)."""
        buf = self._require(key)
        if buf.resident is not None:
            return FAILURE_CODE          # already near
        if buf.pending_rid != FAILURE_CODE:
            return buf.pending_rid       # already in flight
        rid = self.amu.aload(buf.home, nbytes=max(1, buf.nbytes),
                             config=self.fetch_config)
        buf.pending_rid = rid
        self._rid_to_key[rid] = key
        return rid

    def poll(self) -> Optional[Hashable]:
        """getfin: complete at most one outstanding fetch; return its key.

        A FAILED request is reaped — its entry reverts to fetchable (the
        home copy is intact) — and reported as no completion."""
        try:
            rid = self.amu.getfin()
        except AMUError:
            self._reap_failed()
            return None
        if rid == FAILURE_CODE:
            return None
        return self.complete_rid(rid, self.amu.request(rid).payload)

    def get(self, key: Hashable) -> Any:
        """Blocking read: prefetch if needed, wait, return near copy.

        Fault-safe: a failed transfer raises :class:`AMUError` but the
        entry's home copy survives and ``pending_rid`` is cleared, so a
        retry after the fault clears re-issues the aload — the far tier
        never loses data to a transient fetch fault."""
        buf = self._require(key)
        if buf.resident is not None:
            return buf.resident
        rid = buf.pending_rid
        if rid == FAILURE_CODE:
            rid = self.prefetch(key)
        req = self.amu.wait(rid)
        self._rid_to_key.pop(rid, None)
        buf.pending_rid = FAILURE_CODE
        if req.error is not None:
            self.stats["fetch_failed"] += 1
            raise AMUError(
                f"far-tier fetch of {key!r} failed") from req.error
        buf.resident = req.payload
        return buf.resident

    # -- shared-AMU completion forwarding ------------------------------------
    def complete_rid(self, rid: int, payload: Any,
                     error: Optional[BaseException] = None
                     ) -> Optional[Hashable]:
        """Land a completion consumed elsewhere on a *shared* AMU (the
        pager's poll drains one completion queue for both consumers and
        forwards ids it does not own here).  Returns the key, or None
        for a foreign/unknown rid."""
        key = self._rid_to_key.pop(rid, None)
        if key is None:
            return None
        buf = self._store.get(key)
        if buf is None:
            return None
        buf.pending_rid = FAILURE_CODE
        if error is not None:
            self.stats["fetch_failed"] += 1
            return None                  # home intact: retry re-issues
        buf.resident = payload
        return key

    def _reap_failed(self) -> None:
        from .amu import RequestState
        for rid in list(self._rid_to_key):
            req = self.amu.request(rid)
            if req.state is RequestState.FAILED:
                self.complete_rid(rid, None, error=req.error
                                  or AMUError(f"request {rid} failed"))

    def evict(self, key: Hashable) -> None:
        """Drop the near-tier copy (home copy remains)."""
        self._require(key).resident = None

    def keys(self) -> List[Hashable]:
        return list(self._store)

    def resident_bytes(self) -> int:
        return sum(b.nbytes for b in self._store.values()
                   if b.resident is not None)

    def _require(self, key: Hashable) -> OffloadedBuffer:
        if key not in self._store:
            raise KeyError(f"far tier has no entry {key!r}")
        return self._store[key]


class StreamingPrefetcher:
    """Layer-weight streaming: aload layer i+depth while computing layer i.

    The paper's stream pattern at tensor granularity.  ``schedule`` is the
    ordered key sequence (e.g. layer indices); ``step()`` is called once
    per consumed element and keeps ``depth`` fetches in flight.
    """

    def __init__(self, tier: FarMemoryTier, schedule: List[Hashable],
                 depth: int = 2) -> None:
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.tier = tier
        self.schedule = list(schedule)
        self.depth = depth
        self._next_fetch = 0
        self._next_consume = 0
        self.fetch_overlap_events = 0   # fetches issued while compute pending

    def start(self) -> None:
        for _ in range(min(self.depth, len(self.schedule))):
            self.tier.prefetch(self.schedule[self._next_fetch])
            self._next_fetch += 1

    def step(self) -> Any:
        """Blocking get of the next element; tops up the pipeline."""
        if self._next_consume >= len(self.schedule):
            raise IndexError("prefetcher exhausted")
        key = self.schedule[self._next_consume]
        self._next_consume += 1
        value = self.tier.get(key)
        if self._next_fetch < len(self.schedule):
            self.tier.prefetch(self.schedule[self._next_fetch])
            self._next_fetch += 1
            self.fetch_overlap_events += 1
        return value

    def consume_all(self, fn: Callable[[Any], None]) -> None:
        self.start()
        for _ in range(len(self.schedule) - self._next_consume):
            fn(self.step())
