"""The admission role component: how requests enter compute.

:class:`AdmissionMixin` owns everything between the queue and a live
slot: watermark/SLO admission gating and chunk-queue admission, which
installs a slot and page-table bookkeeping only — the prompt is then
computed chunk by chunk by the mixed step.  It is the JAX package's
``serve/admission.py`` without the paths this port does not have yet
(whole-prompt dense prefill, prefix-cache mapping, the DECODE-role
handoff admission).  The mixin assumes the host class provides the
engine state surface — ``serve/engine.py`` assembles it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.paging import EventKind, pages_for

__all__ = ["AdmissionMixin"]


class AdmissionMixin:
    """Chunk-queue admission (see the module docstring).  Mixed into
    :class:`~repro_torch.serve.engine.Engine`."""

    def _admit(self) -> None:
        self._try_finish_resumes()
        now = self.clock()
        self.sched.order_queue(self.queue, now)
        while self.queue:
            req = self.queue[0]
            if req.arrival_t > now:
                break                 # trace replay: not in the system yet
            if req.parked:                                # preempted: resume
                if req.rid in self._resuming or not self._start_resume(req):
                    break
                self.queue.pop(0)
                self._try_finish_resumes()
                continue
            if not self.pool.n_free:
                break
            need = pages_for(min(len(req.prompt), self.slot_tokens),
                             self.page_size)
            if not self.sched.may_admit(req, need):
                # SLO load shedding: the highest-priority admissible
                # request is batch-tier and the pool is too tight to
                # take it without risking interactive deadlines
                self.stats["shed_admissions"] += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "engine", "sched", "shed",
                        {"rid": req.rid, "tier": req.tier.name,
                         "need_pages": need,
                         "free": self.page_pool.n_free})
                break
            if not self.policy.can_admit(self.page_pool, need) and \
                    not self._make_room(need + self.policy.low,
                                        frozenset(), preempt=False):
                break
            self.queue.pop(0)
            slot = self.pool.alloc()
            req.slot = slot
            # install bookkeeping only: the prompt is computed chunk by
            # chunk by the mixed step, interleaved with running decodes
            self.page_table.register(req.rid)
            req.target_len = len(req.prompt)
            req.chunk_rows = np.full((self.pages_per_seq,),
                                     self.trash_frame, np.int32)
            req.admit_seq = next(self._admits)
            self.prefilling[slot] = req
            self.stats["admitted"] += 1
            self._obs_phase(req, "prefill")
            self.events.post(EventKind.ADMIT, req.rid)
