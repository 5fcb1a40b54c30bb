"""The decode-loop role component: the step and the finish path.

:class:`DecodeMixin` owns chunk-vs-decode work selection, draft
proposal, the mixed / decode / verify step dispatch, speculative
acceptance and rollback, prefill graduation (with the prefix cache's
intern hook), greedy sampling and the request finish path — including
the one hook that differentiates the engine roles, :meth:`_role_done`.
A FUSED or DECODE engine finishes a request when its token budget (or
EOS) says so; a PREFILL engine finishes it at its *first token*, where
the ordinary ``offload_finished`` park plus a published handoff record
hand it to the decode side.  It is the JAX package's
``serve/decode.py``.  Greedy sampling takes ``torch.argmax`` on the
device and copies back only the token ids; like ``np.argmax`` it picks
the first maximum.  The hybrid family's chunks are of one exact shape
(pad tokens would enter the recurrent state), and each row's state rides
from chunk to chunk in ``Request.chunk_ssm`` (on the device while it
prefills; host memory while it is parked) until graduation writes it
into the slot.  The mixin assumes the host class provides the engine
state surface — ``serve/engine.py`` assembles it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.amu import QoS
from repro_torch.paging import EventKind, PagingError
from repro_torch.serve.config import EngineRole, Tier
from repro_torch.serve.kv_cache import tree_map
from repro_torch.serve.request import Request

__all__ = ["DecodeMixin"]


class DecodeMixin:
    """Decode loop + finish path (see the module docstring).  Mixed
    into :class:`~repro_torch.serve.engine.Engine`."""

    # -- the role hook ---------------------------------------------------------
    def _role_done(self, req: Request) -> bool:
        """Is this request finished *for this engine's role*?  FUSED and
        DECODE: the request's own budget/EOS (``req.done``).  PREFILL:
        any first token — whether the request is done under fused
        semantics travels on the handoff record (``rec.done``)."""
        if self.role is EngineRole.PREFILL:
            return bool(req.generated)
        return req.done

    # -- chunk-queue scheduling (chunked paged prefill) ------------------------
    def _select_chunks(self) -> List:
        """Pick chunk-vs-decode work for this step.

        A chunk for the oldest admitting slots runs fused with the
        decode step when (a) the LATENCY aload window has room — resume
        traffic saturating the per-QoS window (§2.2 MACR) means parked
        pages are mid-flight and chunk compute would only delay their
        landing — and (b) the chunk's pages fit the pool without
        preempting anyone (chunk growth, like decode growth, is a
        continuation and so is exempt from the admission low
        watermark)."""
        if not self.prefilling:
            return []
        if self._resuming and not self.pager.windows.has_room(QoS.LATENCY):
            return []
        picks: List = []
        t_exact = None
        exact = self.cfg.family == "hybrid"    # pad tokens corrupt SSM state
        for req in self.sched.chunk_order(self.prefilling.values()):
            if len(picks) >= self.chunk_slots:
                break
            start = req.prefill_pos
            end = min(req.target_len, start + self.chunk_tokens)
            if exact and t_exact is not None and end - start != t_exact:
                continue                   # exact-shape batch: next step
            need = self.page_table.pages_needed(req.rid, end)
            if need and not self._make_room(need, frozenset({req.rid}),
                                            preempt=False):
                continue                   # pool tight: decode-only step
            if exact and t_exact is None:
                t_exact = end - start      # pin shape only once a row fits
            self._alloc_pinned(req, end)
            picks.append((req, start, end))
        return picks

    def _force_chunk(self) -> List:
        """Nothing decodable and no chunk fit the pool politely: force
        the oldest admitting slot's chunk through, preempting (parking
        another half-prefilled victim) if that is what it takes — the
        loop must always progress."""
        req = min(self.prefilling.values(), key=lambda r: r.admit_seq)
        end = min(req.target_len, req.prefill_pos + self.chunk_tokens)
        need = self.page_table.pages_needed(req.rid, end)
        if need and not self._make_room(need, frozenset({req.rid}),
                                        preempt=True):
            raise PagingError(
                f"chunked prefill of request {req.rid} cannot progress: "
                f"pool of {self.page_pool.n_pages} pages exhausted")
        self._alloc_pinned(req, end)
        return [(req, req.prefill_pos, end)]

    def _build_chunk(self, picks) -> Dict[str, Any]:
        """Assemble the mixed step's chunk operand (C = ``chunk_slots``
        rows of T = ``chunk_tokens``, unused rows inert with length 0 /
        trash page rows), as int32 tensors on the engine's device.  The
        hybrid family's T is the picks' one exact length, and its rows'
        carries (zero for the unused rows) go in as ``ssm``; the
        encoder-decoder's rows name their slots and source lengths
        (``slots``, ``src_len``), whose cross rows they attend."""
        C = self.chunk_slots
        hybrid = self.cfg.family == "hybrid"
        T = picks[0][2] - picks[0][1] if hybrid else self.chunk_tokens
        tokens = np.zeros((C, T), np.int32)
        offset = np.zeros((C,), np.int32)
        length = np.zeros((C,), np.int32)
        slots = np.zeros((C,), np.int32)
        src_len = np.zeros((C,), np.int32)
        rows = np.full((C, self.pages_per_seq), self.trash_frame, np.int32)
        for i, (req, start, end) in enumerate(picks):
            tokens[i, :end - start] = req.prompt[start:end]
            offset[i] = start
            length[i] = end - start
            slots[i] = req.slot
            src_len[i] = req.src_len
            rows[i] = req.chunk_rows
        named = [("tokens", tokens), ("offset", offset), ("length", length),
                 ("page_rows", rows)]
        if self.cfg.family == "encdec":
            named += [("slots", slots), ("src_len", src_len)]
        chunk = {name: torch.from_numpy(a).to(self.device)
                 for name, a in named}
        if hybrid:
            trees = [r.chunk_ssm for r, _, _ in picks]
            trees += [self._zero_chunk_ssm] * (C - len(picks))
            chunk["ssm"] = tree_map(
                lambda *xs: torch.cat([x.to(self.device) for x in xs],
                                      dim=1), *trees)
        return chunk

    def _finish_chunks(self, picks, first_tokens: np.ndarray,
                       carry=None) -> None:
        """Advance every picked request past its chunk, its row of the
        chunk's ``carry`` (hybrid) its state so far; rows that just
        covered their prompt's last token graduate to the decode batch
        (their first token is the argmax of the chunk's last-valid
        logits)."""
        tr = self.tracer
        for i, (req, start, end) in enumerate(picks):
            req.prefill_pos = end
            if tr.enabled:
                tr.instant("requests", f"req{req.rid}", "chunk",
                           {"start": start, "end": end,
                            "target": req.target_len})
            if carry is not None:
                req.chunk_ssm = tree_map(lambda a: a[:, i:i + 1].clone(),
                                          carry)
            if end >= req.target_len:
                self._finalize_prefill(req, int(first_tokens[i]))

    def _finalize_prefill(self, req: Request, first: int) -> None:
        """Graduate a fully-prefilled request into the decode batch: the
        device page-table row flips from the trash frame to the real
        frames (one host-mirror write — the KV is already in its pool
        frames) and the slot's position, and the hybrid family's state
        carry, land in the cache."""
        slot = req.slot
        self._pt_np[slot] = req.chunk_rows
        self._pt_dirty = True
        self._set_pos(slot, req.target_len)
        if req.chunk_ssm is not None:
            tree_map(lambda dst, src: dst[:, slot:slot + 1].copy_(src),
                      self.cache.ssm, req.chunk_ssm)
            req.chunk_ssm = None
        req.chunk_rows = None
        del self.prefilling[slot]
        if self.prefix is not None:
            # donate the prompt's full pages to the prefix cache: later
            # requests with the same prefix share these frames instead
            # of running their chunks
            self.prefix.intern(req.prompt, req.rid, self._read_frame)
        req.generated.append(first)
        req.first_token_t = self.clock()
        req.token_ts.append(req.first_token_t)
        self.active[slot] = req
        self._obs_phase(req, "decode")
        if self.tracer.enabled:
            self.tracer.instant(
                "requests", f"req{req.rid}", "first_token",
                {"ttft_s": req.first_token_t - req.arrival_t})
        self._finish_if_done(req)

    def _propose_drafts(self) -> Dict[int, int]:
        """Ask the proposer for a draft per active slot (speculation on).

        Returns rid -> draft length; the drafted tokens themselves land
        in ``self._draft_toks``.  Drafts are capped to the slot's token
        head-room and the request's remaining budget (a draft past the
        budget could never commit — the bonus token uses the last unit),
        and trimmed at the first drafted EOS.  An empty dict means this
        step runs the plain single-token path."""
        drafts: Dict[int, int] = {}
        self._draft_toks: Dict[int, List[int]] = {}
        pos_np = self.cache.pos.cpu().numpy()
        if any(int(pos_np[slot]) + 1 > self.slot_tokens
               for slot in self.active):
            # a slot at full capacity writes its token at the clamped
            # last row in decode_step but would scatter to the trash
            # frame in verify_step — plain path for the whole batch
            return drafts
        for slot, req in self.active.items():
            pos = int(pos_np[slot])
            room = self.slot_tokens - pos - 1
            budget = req.max_new_tokens - len(req.generated) - 1
            cap = min(self.speculate_k, room, budget)
            if cap <= 0:
                continue
            history = req.prompt.tolist() + req.generated
            draft = list(self.proposer.propose(req.rid, history))[:cap]
            if req.eos_id is not None and req.eos_id in draft:
                draft = draft[:draft.index(req.eos_id) + 1]
            if draft:
                drafts[req.rid] = len(draft)
                self._draft_toks[req.rid] = draft
        return drafts

    def _step(self) -> None:
        drafts = self._propose_drafts() \
            if self.speculating and self.active else {}
        if self.paging:
            # draft-aware growth: a speculating slot pins frames for its
            # whole write window [pos, pos + 1 + draft); entries clamp
            # in place when the pool cannot cover the full draft
            self._ensure_growth(drafts or None)
        picks = self._select_chunks() if self.chunking else []
        if self.chunking and not picks and not self.active \
                and self.prefilling and not self._resuming:
            picks = self._force_chunk()
        if not self.active and not picks:
            return
        if drafts:
            # growth/chunk allocation may have preempted a drafting slot
            # (its draft dies with the park) or clamped a draft to zero
            live = {req.rid for req in self.active.values()}
            drafts = {r: n for r, n in drafts.items() if r in live and n > 0}
        if self.paging and self._pt_dirty:
            # refresh the device page-table rows from the host mirror
            # (skipped on steady-state steps with no scheduling events)
            self.cache.kv["page_table"].copy_(torch.from_numpy(self._pt_np))
            self._pt_dirty = False
        if drafts:
            self._spec_step(drafts, picks)
            return
        toks = np.zeros((self.max_batch, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.generated[-1]
        toks = torch.from_numpy(toks).to(self.device)
        if picks:
            logits, chunk_logits, carry, self.cache = self._mixed(
                self.params, self.cache, toks, self._build_chunk(picks))
            self.stats["mixed_steps"] += 1
            self.stats["chunks"] += len(picks)
        else:
            logits, self.cache = self._decode(self.params, self.cache, toks)
        self.stats["steps"] += 1
        if self.active:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            t_now = self.clock()
            tr = self.tracer
            for slot, req in list(self.active.items()):
                req.generated.append(int(nxt[slot]))
                req.token_ts.append(t_now)
                if tr.enabled:
                    tr.instant("requests", f"req{req.rid}", "token",
                               {"n": len(req.generated)})
                self._finish_if_done(req)
        if picks:
            self._finish_chunks(
                picks, torch.argmax(chunk_logits, dim=-1).cpu().numpy(),
                carry)

    def _spec_step(self, drafts: Dict[int, int], picks: List) -> None:
        """One speculative verify-K step: score every slot's draft in one
        step (fused with a prompt chunk when ``picks``), then accept and
        roll back on the host.

        Greedy acceptance: the longest draft prefix that matches the
        verify logits' argmax commits, plus one *bonus* token from the
        first non-matching row — so a fully rejected draft still commits
        the plain step's token, and the stream equals single-step greedy
        decode as long as verify row s computes what the s-th sequential
        decode step would.  Rollback is host-only: the verify step never
        advances ``pos``; the engine writes ``pos + appended`` back (one
        upload for the batch) and :meth:`~repro_torch.paging.PageTable.
        rewind_tokens` drops any page left holding only the rejected
        tail, whose K/V past the new ``pos`` is dead — masked by every
        later read, overwritten by later appends, and outside a later
        park's freshness tag, which derives from ``pos``."""
        S = self.speculate_k + 1
        toks = np.zeros((self.max_batch, S), np.int32)
        length = np.zeros((self.max_batch,), np.int32)
        per_slot: Dict[int, List[int]] = {}
        for slot, req in self.active.items():
            d = self._draft_toks.get(req.rid, [])[:drafts.get(req.rid, 0)]
            per_slot[slot] = d
            toks[slot, 0] = req.generated[-1]
            toks[slot, 1:1 + len(d)] = d
            length[slot] = 1 + len(d)
        toks = torch.from_numpy(toks).to(self.device)
        length = torch.from_numpy(length).to(self.device)
        if picks:
            logits, chunk_logits, carry, self.cache = self._mixed_verify(
                self.params, self.cache, toks, length,
                self._build_chunk(picks))
            self.stats["mixed_steps"] += 1
            self.stats["chunks"] += len(picks)
        else:
            logits, self.cache = self._verify(self.params, self.cache, toks,
                                              length)
        self.stats["steps"] += 1
        self.stats["spec_steps"] += 1
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()     # (B, S)
        pos_np = self.cache.pos.cpu().numpy().copy()
        t_now = self.clock()
        tr = self.tracer
        step_drafted = step_accepted = 0
        for slot, req in list(self.active.items()):
            d = per_slot[slot]
            m = len(d)
            start = int(pos_np[slot])
            acc = 0
            while acc < m and d[acc] == int(greedy[slot, acc]):
                acc += 1
            appended = 0
            for t in d[:acc] + [int(greedy[slot, acc])]:
                req.generated.append(int(t))
                req.token_ts.append(t_now)
                appended += 1
                if tr.enabled:
                    tr.instant("requests", f"req{req.rid}", "token",
                               {"n": len(req.generated)})
                if self._role_done(req):
                    break
            step_drafted += m
            step_accepted += min(acc, appended)   # drafts actually appended
            # positions are host-owned across a verify step: advance by
            # what committed, and drop pages holding only rejected tail
            pos_np[slot] = start + appended
            if self.page_table.rewind_tokens(req.rid, start + appended):
                keep = self.page_table.n_pages(req.rid)
                self._pt_np[slot, keep:] = self.trash_frame
                self._pt_dirty = True
        # write the positions back BEFORE finishing slots and graduating
        # chunks: both read or write ``cache.pos`` (a finish may offload
        # the request's KV, which reads it)
        self.cache = self.cache._replace(
            pos=torch.from_numpy(pos_np).to(self.device))
        for req in list(self.active.values()):
            self._finish_if_done(req)
        self.stats["drafted"] += step_drafted
        self.stats["accepted"] += step_accepted
        self.stats["rejected"] += step_drafted - step_accepted
        if tr.enabled:
            tr.instant("engine", "spec", "verify",
                       {"drafted": step_drafted,
                        "accepted": step_accepted,
                        "rejected": step_drafted - step_accepted})
            tr.counter("engine", "spec_drafted", self.stats["drafted"])
            tr.counter("engine", "spec_accepted", self.stats["accepted"])
            tr.counter("engine", "spec_rejected", self.stats["rejected"])
        if picks:
            self._finish_chunks(
                picks, torch.argmax(chunk_logits, dim=-1).cpu().numpy(),
                carry)

    def _finish_if_done(self, req: Request) -> None:
        if not self._role_done(req):
            return
        if self.speculating:
            self.proposer.drop(req.rid)
        slot = req.slot
        if slot is not None and slot in self.active:
            del self.active[slot]
        if slot is not None:
            if self.offload_finished:
                self._offload_finished(req)
                if self.role is EngineRole.PREFILL:
                    # graduation: pages and residue are in the shared
                    # tier; publish the record the DECODE engine admits
                    self._publish_handoff(req)
            if self.paging:
                self._pt_np[slot] = self.trash_frame
                self._pt_dirty = True
            self.pool.release(slot)
        req.done_t = self.clock()
        self.finished[req.rid] = req
        self.stats["slo_attained" if req.slo_attained()
                   else "slo_missed"] += 1
        if req.token_ts:
            tier = req.tier.name
            self.metrics.observe(f"engine/ttft_s/{tier}", req.ttft)
            if len(req.token_ts) > 1:
                self.metrics.observe(f"engine/tpot_s/{tier}", req.tpot)
        if self.tracer.enabled:
            self._obs_phase(req, None)       # close the lifecycle track
            self.tracer.instant(
                "requests", f"req{req.rid}", "finish",
                {"tier": req.tier.name, "arrival": req.arrival_t,
                 "first_token": req.first_token_t, "done": req.done_t,
                 "n_new": len(req.generated),
                 "n_preempts": req.n_preempts,
                 "ttft_slo": req.ttft_slo, "tpot_slo": req.tpot_slo,
                 "attained": bool(req.slo_attained())})
        self.events.post(EventKind.COMPLETE, req.rid)
        self.events.drain()

    # -- SLO telemetry --------------------------------------------------------
    def slo_report(self) -> Dict[str, Any]:
        """Per-tier SLO attainment over the finished requests, on the
        engine's one clock (virtual seconds by default).  *Goodput* is
        tokens generated by requests that met every SLO they carry."""
        elapsed = max(self.clock(), 1e-12)
        out: Dict[str, Any] = {"elapsed": elapsed}
        for tier in Tier:
            reqs = [r for r in self.finished.values() if r.tier is tier]
            ttfts = sorted(r.ttft for r in reqs if r.token_ts)
            good = [r for r in reqs if r.slo_attained()]
            good_tokens = sum(len(r.generated) for r in good)
            out[tier.name.lower()] = {
                "n": len(reqs),
                "attained": len(good),
                "attainment": len(good) / len(reqs) if reqs else 1.0,
                "good_tokens": good_tokens,
                "goodput": good_tokens / elapsed,
                "ttft_p50": (float(np.percentile(ttfts, 50))
                             if ttfts else 0.0),
                "ttft_p95": (float(np.percentile(ttfts, 95))
                             if ttfts else 0.0),
                "ttft_p99": (float(np.percentile(ttfts, 99))
                             if ttfts else 0.0),
            }
        return out
