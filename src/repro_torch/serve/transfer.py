"""The transfer role component: every byte the engine moves.

:class:`TransferMixin` owns the park/resume machinery and the
device-pool plumbing — frame reads/lands, room-making (evict → drain →
preempt), page shedding with the clean-park fast path, and resume
prefetch + slot re-entry.  It is the FUSED-role part of the JAX
package's ``serve/transfer.py``: the host logic is a copy, and the two
device operations are rewritten onto tensors —

  * :meth:`_read_frame` copies one frame of every layer, (L, page, Hkv,
    D) of K and of V, from the device pool to host memory: the page
    payload the pager's astores park in the far tier; a quantized pool's
    payload also carries the frame's (L, Hkv) f32 ``k_scale`` /
    ``v_scale``, and its int8 / fp8 bytes move as ``uint8``;
  * :meth:`_land_frame` copies such a payload back into its frame, in
    place (the JAX package scatters into a donated pool instead): a byte
    copy, never a requantization.

The mixin assumes the host class provides the engine state surface
(``page_pool``/``page_table``/``pager``/``cache``/``sched``/…) —
``serve/engine.py`` assembles it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.paging import EventKind, PageState, PagingError, pages_for
from repro_torch.serve.request import Request

__all__ = ["TransferMixin"]


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
        slot freed, request back to the head of the queue.  The only
        non-KV state a dense decoder carries is the slot's position,
        which rides along as the residue."""
        slot = req.slot
        tokens = int(self.cache.pos[slot])
        self._shed_pages(req, min(tokens, self.slot_tokens))
        req.residue = tokens
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
        chunk queue on resume — no prefill work is redone."""
        slot = req.slot
        self._shed_pages(req, req.prefill_pos)
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
        frames and restore the slot's position.  A request parked
        *mid-prefill* re-enters the chunk queue instead of the decode
        batch: its device page-table row stays on the trash frame and its
        completed-chunk frames go back into ``chunk_rows``."""
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
            req.admit_seq = next(self._admits)
            if req.mid_prefill:
                req.chunk_rows = rows
                self.prefilling[slot] = req
            else:
                self._pt_np[slot] = rows
                self._pt_dirty = True
                self._set_pos(slot, req.residue)
                req.residue = None
                self.active[slot] = req
            del self._resuming[rid]
            self.stats["resumes"] += 1
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

    def _ensure_growth(self, drafts: Optional[Dict[int, int]] = None
                       ) -> None:
        """Before a decode step: every active sequence about to cross a
        page boundary gets a pinned frame, evicting/preempting under the
        watermark policy when the pool is short.

        ``drafts`` (rid -> drafted tokens) widens a speculating slot's
        write window from one position to ``1 + drafts[rid]`` — the
        verify step scatters K/V at ``[pos, pos + 1 + drafts[rid])``,
        possibly straddling a page boundary, so enough frames are pinned
        up front.  The speculative extra degrades instead of failing:
        when the pool cannot cover the full draft the entry is clamped in
        place (down to 0 = plain decode) and only the base ``pos + 1``
        growth must succeed."""
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
