"""Disaggregated prefill/decode over ONE shared far-memory tier.

The port of the JAX package's ``serve/disagg.py`` (host code; a page
payload is a dict of host tensors, so a spool pickles CPU tensors
only).

The paper's AMU exists to hide widely-distributed far-memory latency in
disaggregated data centers; this module points the serving engine's
park/resume machinery *across* engines instead of within one.  A
PREFILL-role engine (``EngineRole.PREFILL``) graduates every sequence
at its first token: the finished prompt pages BULK-park into the shared
:class:`~repro_torch.core.offload.FarMemoryTier` together with the aux
residue (the ordinary ``offload_finished`` machinery), and a
:class:`HandoffRecord` is published on a :class:`HandoffBoard`.  A
DECODE-role engine admits the record
(:meth:`~repro_torch.serve.engine.Engine.admit_handoff`): the aux entry is
LATENCY-fetched through the pager's fault-safe
:meth:`~repro_torch.paging.Pager.fetch_keys` helper, the pages register as
PARKED page-table entries, and the request rides the ordinary resume
path into a decode slot — prefix cache and SLO tiers preserved on both
sides.

**Handoff-record invariants** (what the property tests pin down):

  * a record is published only *after* every page astore and the aux
    entry have been started against the tier — the tier is the single
    source of truth; the record carries identity + SLO contract only,
  * tier entries are discarded only after every transfer verifiably
    landed: the aux entry inside ``fetch_keys(discard_after=True)``
    (a fault raises first, homes intact, so admission retries), the
    page entries at decode-side request completion,
  * rids are globally unique across the pair: the decode engine bumps
    its own rid counter past every handed-off rid,
  * a record whose request already completed at its first token
    (``rec.done``) never enters the decode loop — the decode engine
    finishes it on admission and clears its tier entries.

**Topology** (why three AMUs): each engine's pager owns a private AMU —
a pager forwards completions it does not recognise to *the tier*, not
to other pagers, so two pagers sharing one completion queue would
misroute each other's transfers.  The shared tier gets its own AMU for
the traffic it models itself (aux offload/fetch).  All three ride
simulated backends on virtual time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np

from repro_torch.core.amu import AMU, SimBackend
from repro_torch.core.offload import FarMemoryTier
from repro_torch.paging import Pager, PagingError
from repro_torch.serve.config import Tier

if TYPE_CHECKING:                         # pragma: no cover - typing only
    from repro_torch.serve.engine import Engine

__all__ = ["HandoffRecord", "HandoffBoard", "make_shared_tier",
           "tier_pager_factory", "run_disaggregated",
           "spool_save", "spool_load"]


@dataclass
class HandoffRecord:
    """Everything a DECODE-role engine needs to adopt a prefilled
    request — *except* the KV and aux state, which live in the shared
    far tier under ``(rid, logical)`` / ``(rid, "aux")`` keys exactly as
    ``offload_finished`` parks them.  The record is deliberately tiny
    (identity, SLO contract, first token): the tier is the data plane,
    the board is the control plane."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    n_tokens: int                        # prefilled positions in the tier
    n_pages: int                         # page entries under (rid, logical)
    generated: List[int] = field(default_factory=list)   # the first token
    token_ts: List[float] = field(default_factory=list)
    tier: Tier = Tier.INTERACTIVE
    ttft_slo: Optional[float] = None
    tpot_slo: Optional[float] = None
    arrival_t: float = 0.0
    submitted_t: float = 0.0
    first_token_t: float = 0.0
    done: bool = False                   # done under fused semantics already
    src_len: int = 0                     # encdec: rows of its cross state


class HandoffBoard:
    """The control-plane queue between a PREFILL and a DECODE engine.

    In-process it is a plain FIFO (publish/poll); the launch script's
    ``--handoff-spool`` flag serialises records through a directory so
    the two engines can live in separate processes.  Counters make the
    publish/consume balance checkable by the engines' invariants."""

    def __init__(self) -> None:
        self._recs: List[HandoffRecord] = []
        self.published = 0
        self.consumed = 0

    def publish(self, rec: HandoffRecord) -> None:
        self._recs.append(rec)
        self.published += 1

    def poll(self) -> List[HandoffRecord]:
        """Drain every pending record (FIFO order)."""
        recs, self._recs = self._recs, []
        self.consumed += len(recs)
        return recs

    def __len__(self) -> int:
        return len(self._recs)


# -- shared-tier wiring -------------------------------------------------------

def make_shared_tier(*, base_latency: float = 1e-6,
                     bandwidth: float = 10e9) -> FarMemoryTier:
    """ONE far tier for a PREFILL/DECODE pair, on its own simulated AMU
    (see the module docstring for why the tier cannot share a pager's
    completion queue)."""
    return FarMemoryTier(AMU(SimBackend(base_latency=base_latency,
                                        bandwidth=bandwidth)))


def tier_pager_factory(tier: FarMemoryTier, *, base_latency: float = 1e-6,
                       bandwidth: float = 10e9, **pager_kw):
    """A ``PagingConfig.pager_factory`` whose pagers park into / fetch
    from the given shared ``tier`` — each pager still owns a private
    simulated AMU for its page traffic.  Extra kwargs (QoS window
    sizes, granularity) pass through to :class:`~repro_torch.paging.Pager`.

    Example::

        tier = make_shared_tier()
        mk = tier_pager_factory(tier)
        pre = Engine(cfg, params, EngineConfig(role="prefill",
                     paging=PagingConfig(pager_factory=mk, ...), ...))
        dec = Engine(cfg, params, EngineConfig(role="decode",
                     handoff=pre.handoff,
                     paging=PagingConfig(pager_factory=mk, ...), ...))
    """
    def factory(pool, table, *, page_nbytes: int) -> Pager:
        amu = AMU(SimBackend(base_latency=base_latency,
                             bandwidth=bandwidth))
        return Pager(pool, table, amu, page_nbytes=page_nbytes,
                     tier=tier, **pager_kw)
    return factory


# -- the disaggregated serving loop ------------------------------------------

def run_disaggregated(prefill: "Engine", decode: "Engine",
                      max_steps: int = 10_000) -> Dict[int, List[int]]:
    """Drive a PREFILL/DECODE engine pair to completion.

    Each iteration interleaves one serving step of each engine (so
    decode overlaps prefill exactly as two racks would run
    concurrently), then drains the handoff board into the decode
    engine's admission queue.  Returns the decode engine's outputs —
    ``{rid: tokens}`` with the prefill-side first token included, so
    the mapping is directly comparable against a fused engine's
    :meth:`~repro_torch.serve.engine.Engine.run`.
    """
    from repro_torch.serve.config import EngineRole
    if prefill.role is not EngineRole.PREFILL or \
            decode.role is not EngineRole.DECODE:
        raise PagingError(
            f"run_disaggregated needs a (PREFILL, DECODE) pair; got "
            f"({prefill.role.value}, {decode.role.value})")
    if prefill.far_tier is not decode.far_tier:
        raise PagingError("the two engines must share one FarMemoryTier "
                          "(build both pagers with tier_pager_factory)")
    board = prefill.handoff
    for _ in range(max_steps):
        if not prefill.drained:
            prefill.step_once()
        # the tier's own AMU retires the aux offload astores prefill
        # just started (neither pager polls this queue — see topology)
        prefill.far_tier.poll()
        for rec in board.poll():
            decode.admit_handoff(rec)
        if not decode.drained:
            decode.step_once()
        if prefill.drained and decode.drained and not len(board):
            break
    if prefill.drained:
        prefill.check_invariants()
    if decode.drained:
        decode.check_invariants()
    return {r.rid: r.generated for r in decode.finished.values()}


# -- process-separated handoff (launch script's --handoff-spool) --------------

def spool_save(path: str, recs: List[HandoffRecord],
               tier: FarMemoryTier) -> None:
    """Serialise handoff records *plus their tier entries* into ``path``
    for a separate decode process.  In-process the shared tier is the
    data plane and only records cross the board; across processes the
    spool stands in for the disaggregated memory pool, so each record's
    ``(rid, logical)`` pages and ``(rid, "aux")`` residue travel with
    it."""
    import pickle
    entries: Dict[Any, Any] = {}
    for rec in recs:
        keys = [(rec.rid, logical) for logical in range(rec.n_pages)]
        keys.append((rec.rid, "aux"))
        for key in keys:
            if key in tier:
                entries[key] = (tier.home(key), tier.tokens_of(key))
    with open(path, "wb") as f:
        pickle.dump({"recs": recs, "entries": entries}, f)


def spool_load(path: str, tier: FarMemoryTier) -> List[HandoffRecord]:
    """Load a spool into ``tier`` (entries installed as home copies via
    ``put`` — the transfer they rode is the spool itself) and return the
    records ready for :meth:`~repro_torch.serve.engine.Engine.
    admit_handoff`."""
    import pickle
    with open(path, "rb") as f:
        blob = pickle.load(f)
    for key, (home, tokens) in blob["entries"].items():
        tier.put(key, home, tokens=tokens)
    return blob["recs"]
