"""The transfer role component: every byte the engine moves.

:class:`TransferMixin` owns the park/resume machinery and the
device-pool plumbing — frame reads/lands/copies, room-making (evict →
drain → preempt), page shedding with the clean-park fast path, resume
prefetch + slot re-entry, the copy-on-write guard for prefix-shared
frames, and the finished-sequence offload/fetch pair.  It is
role-agnostic: a FUSED engine points park at its own resume; a PREFILL
engine's graduation is the same :meth:`_offload_finished` park plus a
:meth:`_publish_handoff`; a DECODE engine's handoff admission is the
same resume machinery fed by :meth:`~repro_torch.paging.Pager.
fetch_keys`.  It is the JAX package's ``serve/transfer.py``: the host
logic is a copy, and the device operations are rewritten onto tensors —

  * :meth:`_read_frame` copies one frame of every layer, (L, page, Hkv,
    D) of K and of V, from the device pool to host memory: the page
    payload the pager's astores park in the far tier; a quantized pool's
    payload also carries the frame's (L, Hkv) f32 ``k_scale`` /
    ``v_scale``, and its int8 / fp8 bytes move as ``uint8``;
  * :meth:`_land_frame` copies such a payload back into its frame, in
    place (the JAX package scatters into a donated pool instead): a byte
    copy, never a requantization.  A payload may be shared (a prefix
    hit stores the cache entry's home under the requester's key), so
    nothing writes one;
  * :func:`_copy_frame` / :func:`_copy_frame_q` duplicate a frame in
    place for the copy-on-write break, a quantized frame with both scale
    rows, bytes as they are.
  * :func:`_scatter_seq_pages` / :func:`_scatter_seq_pages_q` write one
    sequence's dense-prefill K/V into its pool frames in place (the
    dense-prefill admission of the paged engine), into a quantized pool
    with one absmax scale per (layer, frame, KV head).

Every residue (a park, a finished-sequence offload, a handoff) is the
:func:`~repro_torch.serve.kv_cache.extract_aux_slot` payload, and
re-entry writes it back with :func:`~repro_torch.serve.kv_cache.
insert_aux_slot`.

The mixin assumes the host class provides the engine state surface
(``page_pool``/``page_table``/``pager``/``cache``/``sched``/…) —
``serve/engine.py`` assembles it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.kv_quant import KVQuantConfig, quantize
from repro_torch.models.model import Cache
from repro_torch.paging import (NOT_MAPPED, EventKind, PageState,
                                PagingError, pages_for)
from repro_torch.serve.disagg import HandoffRecord
from repro_torch.serve.kv_cache import (extract_aux_slot, insert_aux_slot,
                                        join_kv_pages, tree_map)
from repro_torch.serve.request import Request

__all__ = ["TransferMixin", "_scatter_seq_pages", "_scatter_seq_pages_q",
           "_copy_frame", "_copy_frame_q"]


def _seq_pages(single: torch.Tensor, page: int, n_pg: int) -> torch.Tensor:
    """(L, 1, S, Hkv, D) prefill K or V → its leading ``n_pg`` pages,
    (L, n_pg, page, Hkv, D), zero-padded past S."""
    L, _, S, Hkv, D = single.shape
    take = min(n_pg * page, S)
    seq = single[:, 0, :take]
    pad = n_pg * page - take
    if pad:
        seq = torch.nn.functional.pad(seq, (0, 0, 0, 0, 0, pad))
    return seq.reshape(L, n_pg, page, Hkv, D)


def _scatter_seq_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_single: torch.Tensor, v_single: torch.Tensor,
                       frames: torch.Tensor, n_pg: int) -> None:
    """Write one sequence's dense prefill K/V into its pool frames, in
    place.  ``k_single``/``v_single``: (L, 1, S, Hkv, D) from the
    prefill, S the bucket (or the SWA ring); only the leading ``n_pg``
    pages — the prompt's, the frames admission just mapped, ``frames``
    (n_pg,) — are written, the tail zero-padded to a page multiple."""
    page = k_pages.shape[2]
    for pages, single in ((k_pages, k_single), (v_pages, v_single)):
        pages.index_copy_(1, frames, _seq_pages(single, page, n_pg)
                          .to(pages.dtype))


def _scatter_seq_pages_q(k_pages: torch.Tensor, v_pages: torch.Tensor,
                         k_scales: torch.Tensor, v_scales: torch.Tensor,
                         k_single: torch.Tensor, v_single: torch.Tensor,
                         frames: torch.Tensor, n_pg: int, mode: str) -> None:
    """The quantized-pool :func:`_scatter_seq_pages`: each frame's K and
    V quantized with one absmax scale per (layer, frame, KV head), bytes
    and scales written in place (the bytes through ``uint8`` views).
    Admission writes whole frames, so each scale is exact for its
    content; a later decode append grows it by the in-step scatter's
    requantization."""
    qcfg = KVQuantConfig(mode)
    page = k_pages.shape[2]
    for pages, scales, single in ((k_pages, k_scales, k_single),
                                  (v_pages, v_scales, v_single)):
        seq = _seq_pages(single, page, n_pg).float()
        s_new = seq.abs().amax(dim=(2, 4)) * qcfg.inv_qmax  # (L, n_pg, Hkv)
        safe = torch.where(s_new > 0, s_new, torch.ones_like(s_new))
        q = quantize(seq, safe[:, :, None, :, None], qcfg)
        pages.view(torch.uint8).index_copy_(1, frames, q.view(torch.uint8))
        scales.index_copy_(1, frames, s_new)


def _copy_frame(k_pages: torch.Tensor, v_pages: torch.Tensor, src: int,
                dst: int) -> None:
    """Device-side page copy, in place (COW break: a sharer about to
    write a prefix-shared frame gets a private duplicate first).  A
    1-byte pool copies through its ``uint8`` view."""
    if k_pages.element_size() == 1:
        k_pages = k_pages.view(torch.uint8)
        v_pages = v_pages.view(torch.uint8)
    k_pages[:, dst].copy_(k_pages[:, src])
    v_pages[:, dst].copy_(v_pages[:, src])


def _copy_frame_q(k_pages: torch.Tensor, v_pages: torch.Tensor,
                  k_scales: torch.Tensor, v_scales: torch.Tensor, src: int,
                  dst: int) -> None:
    """Quantized-pool COW break: the duplicate keeps the source frame's
    scales, so the copy is byte-exact."""
    _copy_frame(k_pages, v_pages, src, dst)
    k_scales[:, dst].copy_(k_scales[:, src])
    v_scales[:, dst].copy_(v_scales[:, src])


class TransferMixin:
    """Park/resume transfer machinery + device-pool plumbing (see the
    module docstring).  Mixed into :class:`~repro_torch.serve.engine.
    Engine`."""

    # -- paged device-pool plumbing -------------------------------------------
    def _frame_views(self, phys: int) -> Dict[str, torch.Tensor]:
        """Payload key -> the device view of frame ``phys`` it copies:
        (L, page, Hkv, D) of K and V (as ``uint8`` for an int8 / fp8
        pool) and, quantized, the (L, Hkv) scale rows."""
        kv = self.cache.kv
        if "k_scales" not in kv:
            return {"k": kv["k_pages"][:, phys], "v": kv["v_pages"][:, phys]}
        return {"k": kv["k_pages"][:, phys].view(torch.uint8),
                "v": kv["v_pages"][:, phys].view(torch.uint8),
                "k_scale": kv["k_scales"][:, phys],
                "v_scale": kv["v_scales"][:, phys]}

    def _read_frame(self, phys: int) -> Dict[str, torch.Tensor]:
        """Copy one frame's content (L, page, Hkv, D), and a quantized
        frame's scales, to host memory — the page-granularity transfer
        unit the pager's astores move."""
        return {key: view.to("cpu", copy=True)
                for key, view in self._frame_views(phys).items()}

    def _land_frame(self, phys: int) -> None:
        """If the pool frame holds a far-tier payload that has not been
        copied into the device pool yet, land it now (in place, bytes and
        scales as they were read)."""
        frame = self.page_pool.frames[phys]
        if frame.data is None:
            return                       # content already lives in the pool
        for key, view in self._frame_views(phys).items():
            view.copy_(frame.data[key])
        frame.data = None

    def _set_pos(self, slot: int, pos: int) -> None:
        """Write one slot's next position into the device ``pos`` (in
        place: the JAX package rebuilds the array instead)."""
        self.cache.pos[slot] = pos

    # -- paging helpers -------------------------------------------------------
    def _make_room(self, need: int, protect: frozenset,
                   preempt: bool = True) -> bool:
        """Bring the pool to at least ``need`` free frames.  Escalation
        order: getfin poll, LRU eviction of unpinned cached pages,
        draining in-flight fetches (their frames become evictable), then
        — for growth, never for fresh admission — preempting a victim."""
        pool = self.page_pool
        if pool.n_free >= need:
            return True
        self.pager.poll()
        while pool.n_free < need:
            if self.pager.evict_lru(need - pool.n_free):
                continue
            if self._resuming:
                for req in list(self._resuming.values()):
                    self.pager.wait_arriving(req.rid)
                if self.pager.evict_lru(need - pool.n_free):
                    continue
            if not preempt or not self._preempt_one(protect):
                return False
        return True

    def _preempt_one(self, protect: frozenset) -> bool:
        """Park the scheduler's chosen victim — a running sequence
        (:meth:`_park`) or a half-prefilled one whose completed chunks
        are parked as-is (:meth:`_park_prefilling`)."""
        victims = [r for r in list(self.active.values())
                   + list(self.prefilling.values()) if r.rid not in protect]
        if not victims or len(self.active) + len(self.prefilling) <= 1:
            return False
        victim = self.sched.pick_victim(victims, self.clock())
        if victim.mid_prefill:
            self._park_prefilling(victim)
        else:
            self._park(victim)
        return True

    def _shed_pages(self, req: Request, valid: int,
                    hot_pages: Optional[int] = None) -> None:
        """Shared parking machinery: keep the hot tail cached in the
        pool (unpinned, LRU-evictable), move cold pages to the far tier
        — BULK astore for dirty ones, for free when the far copy is
        still current (its valid-token tag equals the page's live token
        count; append-only KV never rewrites a position).  SWA rings
        rewrite pages in place on wrap, so they always write back."""
        rid = req.rid
        n_pages = pages_for(valid, self.page_size)
        # a frame allocated for the *next* write (pos on a page boundary)
        # holds no content yet — release it; resume growth re-allocates
        self.page_table.truncate(rid, n_pages)
        n_hot = min(self.hot_tail_pages if hot_pages is None else hot_pages,
                    n_pages)
        n_cold = n_pages - n_hot
        for logical in range(n_pages - 1, -1, -1):   # tail first: hot
            pte = self.page_table.entry(rid, logical)
            if pte.state is PageState.PARKED:
                continue                 # already far (and current, by
            self.page_table.unpin_page(rid, logical)  # the park invariant)
            cur = min(self.page_size, valid - logical * self.page_size)
            clean = (self.cfg.attention != "swa"
                     and self.pager.far_tokens(rid, logical) == cur)
            if logical >= n_cold:                    # hot tail: stays pooled
                frame = self.page_pool.frames[pte.phys]
                frame.data = None                    # content is in the pool
                frame.dirty = not clean
                frame.tokens = cur   # LRU eviction keeps the freshness tag
                self.page_pool.touch(pte.phys)
            elif clean:
                self.pager.park_clean(rid, logical)  # far copy current
            else:
                self.pager.writeback(rid, logical,
                                     self._read_frame(pte.phys), tokens=cur,
                                     qos=self.sched.store_qos(req))

    def _park(self, req: Request) -> None:
        """Preempt a running sequence: cold pages → far tier (BULK), hot
        tail stays cached *in the device pool* (unpinned, LRU-evictable),
        slot freed, request back to the head of the queue.  The non-KV
        state rides along as the residue (for a dense decoder, the
        slot's position)."""
        slot = req.slot
        tokens = int(self.cache.pos[slot])
        self._shed_pages(req, min(tokens, self.slot_tokens))
        req.residue = extract_aux_slot(self.cache, slot, self.max_batch)
        req.parked = True
        req.n_preempts += 1
        req.slot = None
        self._pt_np[slot] = self.trash_frame
        self._pt_dirty = True
        del self.active[slot]
        self.pool.release(slot)
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1
        self._obs_phase(req, "parked")
        self.events.post(EventKind.PREEMPT, req.rid)

    def _park_prefilling(self, req: Request) -> None:
        """Cancel a half-prefilled sequence: its *completed* chunks park
        exactly like a running sequence's pages (hot tail pooled, cold
        written back), and the prompt remainder simply re-enters the
        chunk queue on resume — no prefill work is redone.  The hybrid
        family's state carry (``req.chunk_ssm``) parks in host memory
        beside the pages, as the reference keeps it host-side."""
        slot = req.slot
        self._shed_pages(req, req.prefill_pos)
        if req.chunk_ssm is not None:
            req.chunk_ssm = tree_map(lambda a: a.to("cpu", copy=True),
                                     req.chunk_ssm)
        req.parked = True
        req.n_preempts += 1
        req.slot = None
        req.chunk_rows = None            # rebuilt from the table on resume
        del self.prefilling[slot]
        self.pool.release(slot)
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1
        self.stats["prefill_preempts"] += 1
        self._obs_phase(req, "parked")
        self.events.post(EventKind.PREEMPT, req.rid)

    def _start_resume(self, req: Request) -> bool:
        """Begin bringing a parked request back: prefetch of its parked
        pages (LATENCY QoS for interactive tier), hot tail first,
        overlapping decode.  A resume is a continuation, not a fresh
        admission, so like growth it is exempt from the low watermark —
        it only needs raw frames."""
        parked = self.page_table.logical_pages(req.rid, PageState.PARKED)
        if self.page_pool.n_free < len(parked) and \
                not self._make_room(len(parked), frozenset({req.rid}),
                                    preempt=False):
            return False
        self.pager.prefetch_seq(req.rid, tail_first=True,
                                qos=self.sched.fetch_qos(req))
        self._resuming[req.rid] = req
        self._obs_phase(req, "resuming")
        return True

    def _try_finish_resumes(self) -> None:
        """Slot in any resuming request whose pages have all arrived.
        Re-entry is a page-table patch: pin the frames, land any payload
        that is still host-side, point the slot's page-table row at the
        frames and restore the residue.  A request parked *mid-prefill*
        re-enters the chunk queue instead of the decode batch: its device
        page-table row stays on the trash frame and its completed-chunk
        frames go back into ``chunk_rows`` (an enc-dec request runs its
        encoder again into the new slot's cross rows: they left with the
        old slot, as in the reference).  A request admitted straight
        onto far-tier prefix pages, or handed off by a PREFILL engine,
        arrives here having never run: that counts as an admission, not
        a resume."""
        for rid, req in list(self._resuming.items()):
            if not self.page_table.resident(rid):
                # pages evicted again under pressure mid-resume get a
                # fresh prefetch (no-op when all are in flight)
                self.pager.prefetch_seq(rid, tail_first=True,
                                        qos=self.sched.fetch_qos(req))
                continue
            if not self.pool.n_free:
                continue
            slot = self.pool.alloc()
            rows = np.full((self.pages_per_seq,), self.trash_frame, np.int32)
            for logical in range(self.page_table.n_pages(rid)):
                pte = self.page_table.entry(rid, logical)
                self.page_table.pin_page(rid, logical)
                self.page_pool.touch(pte.phys)
                self._land_frame(pte.phys)
                rows[logical] = pte.phys
            req.slot = slot
            req.parked = False
            first_admit = req.admit_seq < 0
            req.admit_seq = next(self._admits)
            if req.mid_prefill:
                req.chunk_rows = rows
                if self.cfg.family == "encdec":
                    self._install_cross(req)   # the cross rows left with
                self.prefilling[slot] = req    # the slot: encode again
            else:
                self._ensure_private_tail(req)
                rows = np.full((self.pages_per_seq,), self.trash_frame,
                               np.int32)
                for logical in range(self.page_table.n_pages(rid)):
                    rows[logical] = self.page_table.entry(rid, logical).phys
                self._pt_np[slot] = rows
                self._pt_dirty = True
                insert_aux_slot(self.cache, req.residue, slot,
                                self.max_batch)
                req.residue = None
                self.active[slot] = req
            del self._resuming[rid]
            self.stats["admitted" if first_admit else "resumes"] += 1
            self._obs_phase(req, "prefill" if req.mid_prefill else "decode")
            self.events.post(EventKind.ADMIT, rid)

    def _alloc_pinned(self, req: Request, n_tokens: int) -> None:
        """Allocate (pin + mark dirty) frames so ``req`` covers
        ``n_tokens`` positions and point its slot's page-table row at
        them — active slots own their pages.  While a request is still
        chunk-prefilling, its frames go into the host-side
        ``chunk_rows`` instead: the *device* row keeps pointing at the
        trash frame so the fused decode half of the mixed step cannot
        scribble on a half-written prompt."""
        mid = req.mid_prefill and req.chunk_rows is not None
        for logical in self.page_table.ensure_capacity(req.rid, n_tokens):
            pte = self.page_table.entry(req.rid, logical)
            self.page_table.pin_page(req.rid, logical)
            self.page_pool.mark_dirty(pte.phys)
            if mid:
                req.chunk_rows[logical] = pte.phys
            else:
                self._pt_np[req.slot, logical] = pte.phys
                self._pt_dirty = True

    def _ensure_private(self, req: Request, logical: int) -> None:
        """COW break: if the frame backing ``(req, logical)`` is a
        prefix-shared (copy-on-write) frame this step is about to write,
        remap the page onto a private duplicate first.  Unreachable on
        the sharing families by construction — only *full* prompt pages
        are shared and decode appends strictly after them — but the
        guard keeps the in-place pool scatters (bf16, and the quantized
        ones of :mod:`~repro_torch.kernels.kv_quant`) safe against any
        schedule that routes a write at a shared frame."""
        pte = self.page_table.entry(req.rid, logical)
        if pte.phys == NOT_MAPPED:
            return
        frame = self.page_pool.frames[pte.phys]
        if not frame.cow or frame.refs <= 1:
            return
        old, new = self.page_table.remap_private(req.rid, logical)
        if new == old:
            return
        kv = self.cache.kv
        if "k_scales" in kv:
            _copy_frame_q(kv["k_pages"], kv["v_pages"], kv["k_scales"],
                          kv["v_scales"], old, new)
        else:
            _copy_frame(kv["k_pages"], kv["v_pages"], old, new)
        if req.mid_prefill and req.chunk_rows is not None:
            req.chunk_rows[logical] = new
        elif req.slot is not None:
            self._pt_np[req.slot, logical] = new
            self._pt_dirty = True

    def _ensure_private_tail(self, req: Request) -> None:
        """Guard the page decode writes next (the sequence's last mapped
        page) against COW sharing before the slot goes active."""
        n = self.page_table.n_pages(req.rid)
        if n:
            self._ensure_private(req, n - 1)

    def _ensure_growth(self, drafts: Optional[Dict[int, int]] = None
                       ) -> None:
        """Before a decode step: every active sequence about to cross a
        page boundary gets a pinned frame, evicting/preempting under the
        watermark policy when the pool is short.

        ``drafts`` (rid -> drafted tokens) widens a speculating slot's
        write window from one position to ``1 + drafts[rid]`` — the
        verify step scatters K/V at ``[pos, pos + 1 + drafts[rid])``,
        possibly straddling a page boundary, so every touched mapped page
        gets the COW guard and enough frames are pinned up front.  The
        speculative extra degrades instead of failing: when the pool
        cannot cover the full draft the entry is clamped in place (down
        to 0 = plain decode) and only the base ``pos + 1`` growth must
        succeed."""
        pos_np = self.cache.pos.cpu().numpy()   # one device sync per step
        for req in list(self.active.values()):
            if req.slot is None or req.slot not in self.active:
                continue                    # preempted by an earlier victim
            pos = int(pos_np[req.slot])
            if pos >= self.slot_tokens:
                continue                    # SWA ring wrapped: no growth
            extra = drafts.get(req.rid, 0) if drafts else 0
            if extra and pos + 1 + extra > self.slot_tokens:
                extra = max(0, self.slot_tokens - pos - 1)
            # COW-guard every mapped page the write range touches (the
            # draft tail can straddle into the next page)
            n_mapped = self.page_table.n_pages(req.rid)
            first_wp = pos // self.page_size
            last_wp = min((pos + extra) // self.page_size, n_mapped - 1)
            for wp in range(first_wp, last_wp + 1):
                self._ensure_private(req, wp)
            while True:
                target = pos + 1 + extra
                need = self.page_table.pages_needed(req.rid, target)
                if not need or self._make_room(need, frozenset({req.rid})):
                    break
                if extra == 0:
                    raise PagingError(
                        f"cannot grow request {req.rid}: pool of "
                        f"{self.page_pool.n_pages} pages exhausted")
                extra -= 1              # shed draft positions, not the slot
            if drafts is not None and req.rid in drafts:
                drafts[req.rid] = extra
            if need:
                self._alloc_pinned(req, target)

    # -- finished-sequence offload + cross-engine handoff ---------------------
    def _offload_finished(self, req: Request) -> None:
        """Park a finished sequence page by page into THE far tier — the
        same BULK writeback / clean-park machinery preemption uses.  The
        residue and the page count ride along as one more far-tier entry,
        ``(rid, "aux")``; :meth:`fetch_finished` reassembles the
        sequence, or, under a PREFILL role, a DECODE engine's
        :meth:`~repro_torch.serve.admission.AdmissionMixin.admit_handoff`
        adopts it."""
        slot = req.slot
        rid = req.rid
        tokens = min(int(self.cache.pos[slot]), self.slot_tokens)
        aux = extract_aux_slot(self.cache, slot, self.max_batch)
        self.far_tier.offload(
            (rid, "aux"),
            {"aux": aux, "tokens": tokens,
             "pages": pages_for(tokens, self.page_size)})
        # every page goes far (hot_pages=0): the sequence is leaving the
        # device; shared prefix pages park for free via their aliases
        self._shed_pages(req, tokens, hot_pages=0)

    def _publish_handoff(self, req: Request) -> None:
        """PREFILL-role graduation, control-plane half: the pages and the
        residue are already in the shared tier (:meth:`_offload_finished`);
        publish the identity/SLO record the decode engine admits by,
        strictly *after* every tier entry exists (a record never
        dangles)."""
        meta = self.far_tier.home((req.rid, "aux"))
        rec = HandoffRecord(
            rid=req.rid, prompt=np.asarray(req.prompt),
            max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
            n_tokens=meta["tokens"], n_pages=meta["pages"],
            generated=list(req.generated), token_ts=list(req.token_ts),
            tier=req.tier, ttft_slo=req.ttft_slo, tpot_slo=req.tpot_slo,
            arrival_t=req.arrival_t, submitted_t=req.submitted_t,
            first_token_t=req.first_token_t, done=req.done,
            src_len=req.src_len)
        self.handoff.publish(rec)
        self.stats["handoffs"] += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "requests", f"req{req.rid}", "handoff",
                {"n_pages": rec.n_pages, "n_tokens": rec.n_tokens,
                 "done": rec.done})
        self.events.post(EventKind.HANDOFF, req.rid)

    def fetch_finished(self, rid: int) -> Cache:
        """Reassemble a finished, offloaded request's single-sequence
        :class:`~repro_torch.models.model.Cache` from its far-tier pages
        (LATENCY aloads, all started before the first wait, through the
        pager's fault-safe :meth:`~repro_torch.paging.Pager.fetch_keys`).
        K and V come back as host tensors (L, 1, slot_tokens, Hkv, D) of
        the pool's dtype, bf16 for a quantized pool, whose pages are
        dequantized by their own (L, Hkv) scale pair; positions past the
        sequence are zero.

        Fault-safe: entries are discarded only after *every* transfer
        has verifiably landed — a fault mid-fetch raises, the far copies
        survive and a retry starts the lost aloads again."""
        if not self.offload_finished:
            raise PagingError("engine was not built with offload_finished")
        tier = self.far_tier
        meta = tier.get((rid, "aux"))
        n_pages, tokens = meta["pages"], meta["tokens"]
        keys = [(rid, logical) for logical in range(n_pages)]
        # overlapped fetch; discards only after every payload landed
        payloads = self.pager.fetch_keys(keys, discard_after=True)
        kv = self.cache.kv
        pool_dt = kv["k_pages"].dtype
        quant = "k_scales" in kv
        L, _, page, Hkv, D = kv["k_pages"].shape
        pages = []
        for logical, key in enumerate(keys):
            data = payloads[key]
            take = min(page, tokens - logical * page)
            if take <= 0:
                break
            k, v = data["k"], data["v"]
            if quant:
                # the payload's bytes are the pool's int8 / fp8 codes
                k = k.view(pool_dt).float() \
                    * data["k_scale"][:, None, :, None]
                v = v.view(pool_dt).float() \
                    * data["v_scale"][:, None, :, None]
            pages.append({"k": k[:, None, :take], "v": v[:, None, :take]})
        tier.discard((rid, "aux"))
        aux = meta["aux"]
        kdt = torch.bfloat16 if quant else pool_dt
        residue = Cache(
            kv={"k": torch.zeros((L, 1, 0, Hkv, D), dtype=kdt),
                "v": torch.zeros((L, 1, 0, Hkv, D), dtype=kdt),
                "pos": torch.zeros((), dtype=torch.int32),
                "slots": torch.tensor(self.slot_tokens, dtype=torch.int32)},
            ssm=aux["ssm"], cross=aux["cross"], pos=aux["pos"])
        return join_kv_pages(residue, pages, self.slot_tokens)
