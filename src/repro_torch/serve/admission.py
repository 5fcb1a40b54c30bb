"""The admission role component: how requests enter compute.

:class:`AdmissionMixin` owns everything between the queue and a live
slot: watermark/SLO admission gating, chunk-queue admission (a slot and
page-table bookkeeping only — the prompt is then computed chunk by
chunk by the mixed step), the whole-prompt dense prefill (padded to a
bucket, its K/V scattered into the prompt's pool frames, or inserted
into the slot of the non-paged engine's dense cache) for the prompts the
chunk queue does not take, prefix-cache mapping, and
:meth:`admit_handoff`, the DECODE-role entry point that adopts a
PREFILL-role engine's graduated request straight from the shared far
tier.  A handoff admission is deliberately *not* a new code path: it
rebuilds the request parked (pages registered PARKED against the shared
tier's entries, residue fetched fault-safe) and lets the ordinary resume
machinery in :class:`~repro_torch.serve.transfer.TransferMixin` slot it
in.  It is the JAX package's ``serve/admission.py`` for every family
(the SSM and hybrid families prefill at the prompt's exact length and
install the prefill's recurrent state beside its KV; the
encoder-decoder runs its encoder over the request's source, cut or
zero-padded to the prompt's bucket, and installs the cross state).  The
mixin assumes the host class provides the engine
state surface — ``serve/engine.py`` assembles it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import Cache, encode_cross, prefill
from repro_torch.paging import EventKind, PageState, PagingError, pages_for
from repro_torch.serve.config import EngineRole, Tier
from repro_torch.serve.disagg import HandoffRecord
from repro_torch.serve.kv_cache import insert_aux_slot, insert_slot
from repro_torch.serve.request import Request
from repro_torch.serve.transfer import (_scatter_seq_pages,
                                        _scatter_seq_pages_q)

__all__ = ["AdmissionMixin"]


class AdmissionMixin:
    """Chunk-queue and dense-prefill admission, prefix mapping and
    handoff admission (see the module docstring).  Mixed into
    :class:`~repro_torch.serve.engine.Engine`."""

    # -- dense prefill -------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """The padded length of a ``plen``-token prompt: the smallest
        bucket that holds it, else ``max_len`` (entries past ``plen`` are
        never attended: decode starts at ``plen``).  The SSM and hybrid
        families take ``plen`` itself: pad tokens would enter their
        state."""
        if self.cfg.family in ("ssm", "hybrid"):
            return plen
        for b in self.buckets:
            if plen <= b:
                return b
        return self.max_len

    def _prefill_one(self, req: Request):
        """Prefill the request's whole prompt, padded to its bucket, in
        one dense prefill (one launch of the dense flash attention kernel
        a layer on the card; the encoder-decoder's encoder and cross
        attention too, over its source padded to the same bucket).
        Returns (logits (1, V) at the prompt's last real token, the
        single-sequence dense cache with ``pos`` = the prompt length)."""
        plen = len(req.prompt)
        bucket = self._bucket(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        dev = self.device
        src = self._source(req, bucket) if self.cfg.family == "encdec" \
            else None
        with torch.no_grad():
            # logits from the prompt's true last token (plen - 1), never
            # the padded tail: the chunk queue, which never sees the pad,
            # must agree with this path on the first token
            logits, single = prefill(
                self.params, self.cfg, torch.from_numpy(toks).to(dev),
                max_len=self.max_len,
                last_pos=torch.full((1,), plen - 1, dtype=torch.int32,
                                    device=dev), src_embeds=src)
        self.stats["prefills"] += 1
        return logits, single._replace(
            pos=torch.full((1,), plen, dtype=torch.int32, device=dev))

    def _source(self, req: Request, bucket: int) -> torch.Tensor:
        """An enc-dec request's source as the encoder takes it: its
        ``src_embeds`` (zeros when None) cut or zero-padded to ``bucket``
        rows, (1, bucket, d_model) f32 on the engine's device."""
        src = np.zeros((1, bucket, self.cfg.d_model), np.float32)
        if req.src_embeds is not None:
            se = np.asarray(req.src_embeds, np.float32)[:bucket]
            src[0, :se.shape[0]] = se
        return torch.from_numpy(src).to(self.device)

    def _install_cross(self, req: Request) -> None:
        """Enc-dec chunk-queue admission: run the encoder once over the
        source (padded to the prompt's bucket) and put its cross K/V and
        output in rows ``[0, bucket)`` of the slot's ``cache.cross``;
        every later chunk (``src_len`` = bucket rows) and decode token
        (all ``max_len`` rows, unmasked, as in the reference: the rows
        past the bucket keep zeros or an earlier occupant's) reads them
        there.  The projections are the dense prefill's, so the two
        admissions agree.  The slot axis is picked by leaf name (k / v
        (L, B, Ssrc, ...), ``enc_out`` (B, Ssrc, d)): a shape rule
        misfires when Ssrc equals ``max_batch``."""
        bucket = self._bucket(len(req.prompt))
        with torch.no_grad():
            cross = encode_cross(self.params, self.cfg,
                                 self._source(req, bucket))
        for name, dst in self.cache.cross.items():
            axis = 1 if name in ("k", "v") else 0
            dst.narrow(axis, req.slot, 1).narrow(axis + 1, 0, bucket).copy_(
                cross[name])
        req.src_len = bucket

    def _install_sequence(self, req: Request, single: Cache) -> None:
        """Dense-prefill admission on the paged layout: scatter the
        prompt's K/V pages into the frames :meth:`_alloc_pinned` just
        mapped (the bucket tail past them is never attended) and install
        the rest of the prefill's state in the slot: its position, the
        hybrid family's recurrent state and the enc-dec cross state (the
        bucket's rows, from row 0)."""
        slot = req.slot
        kv = self.cache.kv
        n_pg = pages_for(min(len(req.prompt), self.slot_tokens),
                         self.page_size)
        frames = torch.from_numpy(self._pt_np[slot, :n_pg].astype(
            np.int64)).to(self.device)
        if "k_scales" in kv:
            _scatter_seq_pages_q(kv["k_pages"], kv["v_pages"],
                                 kv["k_scales"], kv["v_scales"],
                                 single.kv["k"], single.kv["v"], frames,
                                 n_pg, self.kv_quant.mode)
        else:
            _scatter_seq_pages(kv["k_pages"], kv["v_pages"], single.kv["k"],
                               single.kv["v"], frames, n_pg)
        insert_aux_slot(self.cache, {"ssm": single.ssm, "cross": single.cross,
                                     "pos": single.pos}, slot, self.max_batch)

    # -- scheduling ------------------------------------------------------------
    def _chunkable(self, req: Request) -> bool:
        """Chunk-queue admission requires chunking on and the whole prompt
        within the slot's token capacity (an SWA ring that wraps
        mid-prompt would rewrite pages the chunk path still attends);
        the other prompts take the dense prefill."""
        return self.chunking and 0 < len(req.prompt) <= self.slot_tokens

    def _admit_prefix(self, req: Request, hits: List[int]) -> bool:
        """Map prefix-cache hits onto the request's fresh page-table row.

        Device-resident hits are refcount-shared in place (zero traffic,
        zero compute); hits whose shared page lives only in the far tier
        make the request start *parked* — it rides the ordinary resume
        machinery (LATENCY prefetch of a private copy, including the
        resume-while-ARRIVING paths) before its first chunk.  Either
        way ``prefill_pos`` starts past the shared prefix, so those
        chunks are never queued.  Returns True on the far route.
        """
        self.page_table.register(req.rid)
        req.target_len = len(req.prompt)
        far = False
        for l in hits:
            key = self.prefix.far_key(l)
            if self.prefix.entry_state(l) is PageState.RESIDENT:
                phys = self.prefix.entry_phys(l)
                logical = self.page_table.append_shared(req.rid, phys)
                self.page_pool.touch(phys)
            else:
                far = True
                logical = self.page_table.append_parked(req.rid)
                self.stats["prefix_far_hits"] += 1
            # far alias (no copy: the same host payload) so this mapping
            # can always park clean and a far hit fetches through the
            # pager
            self.pager.store_far(req.rid, logical, self.far_tier.home(key),
                                 tokens=self.page_size)
        req.prefill_pos = len(hits) * self.page_size
        self.stats["prefix_hits"] += len(hits)
        self.stats["prefix_tokens_saved"] += req.prefill_pos
        if far:
            req.parked = True
        return far

    def _admit(self) -> None:
        if self.paging:
            self._try_finish_resumes()
        now = self._admit_now = self.clock()
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
            hits: List[int] = []
            if self.paging:
                need = pages_for(min(len(req.prompt), self.slot_tokens),
                                 self.page_size)
                if self.prefix is not None and self._chunkable(req) \
                        and req.rid not in self.page_table.sequences():
                    hits = self.prefix.match(req.prompt)
                    # device-resident hits take no new frames
                    need -= sum(
                        1 for l in hits
                        if self.prefix.entry_state(l) is PageState.RESIDENT)
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
            if hits and self._admit_prefix(req, hits):
                # far-tier hits: request left at the queue head, parked;
                # the next iteration routes it through _start_resume
                continue
            self.queue.pop(0)
            slot = self.pool.alloc()
            req.slot = slot
            if self._chunkable(req):
                self._admit_chunked(req, slot)
                continue
            logits, single = self._prefill_one(req)
            if self.paging:
                self.page_table.register(req.rid)
                self._alloc_pinned(req,
                                   min(len(req.prompt), self.slot_tokens))
                self._install_sequence(req, single)
            else:
                insert_slot(self.cache, single, slot, self.max_batch)
            req.admit_seq = next(self._admits)
            req.generated.append(int(torch.argmax(logits[0]).item()))
            req.first_token_t = self.clock()
            req.token_ts.append(req.first_token_t)
            self.active[slot] = req
            self.stats["admitted"] += 1
            self._obs_phase(req, "decode")
            if self.tracer.enabled:
                self.tracer.instant(
                    "requests", f"req{req.rid}", "first_token",
                    {"ttft_s": req.first_token_t - req.arrival_t})
            self.events.post(EventKind.ADMIT, req.rid)
            self._finish_if_done(req)

    def _admit_chunked(self, req: Request, slot: int) -> None:
        """Chunk-queue admission: install bookkeeping only — the prompt
        is computed chunk by chunk by the mixed step, interleaved with
        every running slot's decode."""
        if req.rid not in self.page_table.sequences():
            self.page_table.register(req.rid)
        req.target_len = len(req.prompt)
        req.chunk_rows = np.full((self.pages_per_seq,), self.trash_frame,
                                 np.int32)
        if self.cfg.family == "hybrid":
            req.chunk_ssm = self._zero_chunk_ssm     # read, never written
        if self.cfg.family == "encdec":
            self._install_cross(req)
        # prefix hits already mapped: pin them for the slot and point the
        # chunk row at the shared frames
        for logical in range(self.page_table.n_pages(req.rid)):
            self.page_table.pin_page(req.rid, logical)
            req.chunk_rows[logical] = \
                self.page_table.entry(req.rid, logical).phys
        req.admit_seq = next(self._admits)
        self.prefilling[slot] = req
        self.stats["admitted"] += 1
        self._obs_phase(req, "prefill")
        self.events.post(EventKind.ADMIT, req.rid)

    # -- cross-engine handoff admission (DECODE role) --------------------------
    def admit_handoff(self, rec: HandoffRecord,
                      arrival_t: Optional[float] = None) -> int:
        """Adopt a PREFILL-role engine's graduated request from the
        shared far tier.

        The residue rides the pager's fault-safe overlapped fetch
        (:meth:`~repro_torch.paging.Pager.fetch_keys` — a mid-transfer
        AMU fault raises with the tier entry intact, so the caller
        retries), the prompt pages register as PARKED page-table entries
        against the tier's ``(rid, logical)`` homes, and the request
        joins the queue *parked*: the ordinary resume machinery
        LATENCY-prefetches the pages and slots it into the decode batch.
        A record already done under fused semantics (a one-token request
        or a first-token EOS) finishes at once and clears its tier
        entries.  Returns the adopted rid (unchanged from the prefill
        side; the local rid counter jumps past it)."""
        if self.role is not EngineRole.DECODE:
            raise PagingError(
                f"admit_handoff requires EngineRole.DECODE; this engine "
                f"is {self.role.value!r}")
        rid = rec.rid
        if rid in self.finished or rid in self.page_table.sequences():
            raise PagingError(f"handoff rid {rid} already known here")
        # handed-off rids stay globally unique: local submissions must
        # never collide with them
        self._next_rid = max(self._next_rid, rid + 1)
        self.far_tier.poll()             # retire the tier-AMU offloads
        now = self.clock()
        req = Request(
            rid=rid, prompt=np.asarray(rec.prompt, np.int32),
            max_new_tokens=rec.max_new_tokens, eos_id=rec.eos_id,
            tier=Tier(rec.tier), ttft_slo=rec.ttft_slo,
            tpot_slo=rec.tpot_slo,
            # both engines' clocks share an origin, so the prefill-side
            # arrival/first-token instants stay meaningful here
            arrival_t=rec.arrival_t if arrival_t is None else arrival_t,
            submitted_t=rec.submitted_t, src_len=rec.src_len)
        req.generated = list(rec.generated)
        req.token_ts = list(rec.token_ts)
        req.first_token_t = rec.first_token_t
        if rec.done:
            # nothing to decode; every transfer already landed, so the
            # tier entries may go
            self.far_tier.discard_seq(rid)
            req.done_t = now
            self.finished[rid] = req
            self.stats["handoffs"] += 1
            self.stats["slo_attained" if req.slo_attained()
                       else "slo_missed"] += 1
            return rid
        # residue: fault-safe overlapped fetch, discarded only after the
        # payload verifiably landed (fault ⇒ raise, entry intact, nothing
        # below this line has happened yet, the handoff counter included)
        meta = self.pager.fetch_keys([(rid, "aux")],
                                     discard_after=True)[(rid, "aux")]
        self.stats["handoffs"] += 1
        self.page_table.register_parked(rid, meta["pages"])
        req.parked = True
        req.residue = meta["aux"]
        self.queue.append(req)
        self.sched.on_submit(req)
        return rid
