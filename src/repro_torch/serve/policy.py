"""The scheduling-policy role component: every discretionary decision.

Queue order, extra admission gating, victim choice, chunk order, and
the QoS class each request's far-memory traffic rides all come through
one :class:`SchedulerPolicy` object (``engine.sched``) — the base class
is the utilisation-maximising watermark scheduler, and
:class:`SLOScheduler` is the goodput scheduler that maps priority
tiers onto the pager's QoS windows.  Both are role-agnostic: a
PREFILL-role engine uses the same EDF chunk ordering and shedding
rules for its admission/chunk queue, and a DECODE-role engine uses the
same victim choice and QoS mapping for its resume traffic — the policy
layer is what stays constant across the fused/disaggregated split.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

from repro_torch.core.amu import QoS
from repro_torch.serve.config import Tier
from repro_torch.serve.request import Request

if TYPE_CHECKING:                         # pragma: no cover - typing only
    from repro_torch.serve.engine import Engine

__all__ = ["SchedulerPolicy", "SLOScheduler", "SCHEDULERS"]


class SchedulerPolicy:
    """The scheduling-policy layer: every discretionary decision the
    engine makes — queue order, extra admission gating, victim choice,
    chunk order, and the QoS class each request's far-memory traffic
    rides — comes through one of these objects (``engine.sched``).

    This base class IS the watermark scheduler (``policy="watermark"``):
    FIFO admission, newest-admitted-first preemption, admission-order
    chunk selection, LATENCY fetches / BULK parks for everyone.  It
    maximises utilisation and is SLO-blind — the exact PR-4/PR-5
    behaviour, bit-for-bit.
    """

    name = "watermark"

    def __init__(self, engine: "Engine"):
        self.eng = engine

    def order_queue(self, queue: List[Request], now: float) -> None:
        """Reorder the admission queue in place (base: FIFO — resumes
        were pushed to the head by preemption and stay there)."""

    def may_admit(self, req: Request, need: int) -> bool:
        """Extra admission gate on top of the free-page watermark
        (base: none)."""
        return True

    def pick_victim(self, victims: List[Request], now: float) -> Request:
        """Choose the preemption victim (base: newest admitted)."""
        return max(victims, key=lambda r: r.admit_seq)

    def chunk_order(self, reqs) -> List[Request]:
        """Order admitting slots for chunk selection (base: admission
        order)."""
        return sorted(reqs, key=lambda r: r.admit_seq)

    def fetch_qos(self, req: Request) -> QoS:
        """QoS class for this request's resume prefetches."""
        return QoS.LATENCY

    def store_qos(self, req: Request) -> QoS:
        """QoS class for this request's preemption writebacks."""
        return QoS.BULK

    def on_submit(self, req: Request) -> None:
        """Hook at submission (base: nothing to arm)."""


class SLOScheduler(SchedulerPolicy):
    """Goodput scheduling (``policy="slo"``): admission, preemption and
    chunk selection maximise *SLO attainment* instead of utilisation,
    and the request's priority tier maps onto the pager's QoS windows —
    the paper's §2.2 MACR QoS applied at request granularity:

      * **queue order** — arrived requests first, INTERACTIVE tier
        before BATCH, earliest deadline first within a tier (EDF);
        parked requests of a tier resume before its fresh admissions
        (their pages are already paid for),
      * **admission shedding** — a BATCH request must leave
        ``batch_headroom`` free pages beyond the low watermark, and
        never admits while an interactive resume is still in flight:
        under overload, batch-tier load is shed first,
      * **preemption** — the victim is a BATCH slot when one exists,
        preferring one whose SLO is *already blown* (evicting it costs
        nothing that isn't lost) and otherwise the one *furthest from
        its next deadline* (most slack to absorb a park/resume
        round-trip),
      * **QoS mapping** — interactive resumes/prefetches ride LATENCY
        aloads and interactive parks STANDARD astores; batch resumes
        ride STANDARD and batch parks BULK — so an interactive
        request's far-memory traffic is never queued behind a batch
        request's in the AMU windows,
      * **deadlines as events** — each submission arms its TTFT
        deadline in a :class:`~repro_torch.paging.DeadlineQueue`; ticks pop
        due deadlines and post ``DEADLINE`` events (§2.3.2: passing
        time is a scheduling event like an arriving page).
    """

    name = "slo"

    def next_deadline(self, req: Request, now: float) -> float:
        """The next instant this request's SLO contract can be missed:
        its TTFT deadline before the first token, then each successive
        token's TPOT budget.  inf when unconstrained."""
        if not req.token_ts:
            if req.ttft_slo is None:
                return float("inf")
            return req.arrival_t + req.ttft_slo
        if req.tpot_slo is None:
            return float("inf")
        return req.token_ts[-1] + req.tpot_slo

    def slack(self, req: Request, now: float) -> float:
        return self.next_deadline(req, now) - now

    def blown(self, req: Request, now: float) -> bool:
        return self.next_deadline(req, now) < now

    def order_queue(self, queue: List[Request], now: float) -> None:
        queue.sort(key=lambda r: (
            r.arrival_t > now,           # future arrivals wait their turn
            int(r.tier),                 # INTERACTIVE before BATCH
            not r.parked,                # resumes before fresh admissions
            self.next_deadline(r, now),  # EDF within the tier
            r.rid))

    def may_admit(self, req: Request, need: int) -> bool:
        eng = self.eng
        if req.tier is not Tier.BATCH or not eng.paging:
            return True
        if not (eng.active or eng.prefilling or eng._resuming):
            return True                  # idle system: nothing to shed for
        if any(r.tier is Tier.INTERACTIVE
               for r in eng._resuming.values()):
            return False                 # interactive resume owns the bus
        headroom = eng.sched_cfg.batch_headroom
        return eng.page_pool.n_free - need >= eng.policy.low + headroom

    def pick_victim(self, victims: List[Request], now: float) -> Request:
        return min(victims, key=lambda r: (
            r.tier is not Tier.BATCH,    # shed batch tier first
            not self.blown(r, now),      # a blown SLO loses nothing more
            -self.slack(r, now),         # then: most slack to spare
            -r.admit_seq))

    def chunk_order(self, reqs) -> List[Request]:
        now = self.eng.clock()
        return sorted(reqs, key=lambda r: (self.next_deadline(r, now),
                                           r.admit_seq))

    def fetch_qos(self, req: Request) -> QoS:
        return QoS.LATENCY if req.tier is Tier.INTERACTIVE else QoS.STANDARD

    def store_qos(self, req: Request) -> QoS:
        return QoS.STANDARD if req.tier is Tier.INTERACTIVE else QoS.BULK

    def on_submit(self, req: Request) -> None:
        if req.ttft_slo is not None:
            self.eng.deadlines.schedule(req.arrival_t + req.ttft_slo,
                                        req.rid)


SCHEDULERS = {"watermark": SchedulerPolicy, "slo": SLOScheduler}
