"""Continuous-batching serving engine over the paged KV subsystem.

The port of ``repro.serve.engine``, paging and chunked prefill on, in
any of its roles: FUSED (one engine does both prefill and decode), or
the PREFILL / DECODE halves of a disaggregated pair over one shared far
tier (:mod:`repro_torch.serve.disagg`).  The
scheduler is the paper's *event-driven model* (§2.3.2) applied to
requests: decode steps are the event loop's ticks; pager ``getfin``
completions post PAGE_ARRIVED events; admission and preemption follow
*free-page watermarks* over the device page pool.

  * each sequence's KV is accounted in fixed-size pages of a shared
    :class:`~repro_torch.paging.PagePool`; active slots pin their pages,
  * when growth (or a new admission) exceeds the pool, a victim is
    *preempted*: only its cold pages are written back to the host far
    tier (BULK-QoS ``astore``; pages whose far copy is still current
    move for free), while the hot tail stays cached on the device,
  * resuming prefetches the parked pages hot tail first with
    LATENCY-QoS ``aload``; the sequence re-enters a slot the moment its
    pages are all resident — no re-prefill.

Compute runs directly on the paged layout: the device cache is a
:class:`~repro_torch.models.model.PagedCache` whose K/V live in the
pool's frames, and every tick runs one mixed step
(:func:`~repro_torch.steps.make_mixed_step`: a decode token for every
running slot, then a prompt chunk for up to ``chunk_slots`` admitting
slots) or a plain decode step.  With ``speculate_k > 0`` an n-gram
proposer drafts up to K tokens per slot and the decode half becomes a
verify-K step that scores all drafts at once; greedy acceptance and a
page-table rewind keep the stream token-exact with plain decode.
Attention reads the pool through the page tables with the hand-written
CUDA kernels on the card.

With ``chunking.prefix_cache`` full prompt pages are interned by a
rolling token-id hash at graduation, and later requests map their
page-table rows onto the shared frames (device hit) or fetch a private
copy with a LATENCY aload (far hit) and skip those chunks
(:mod:`repro_torch.paging.prefix_cache`).  With
``paging.offload_finished`` a finished sequence parks page by page in
the far tier for a later :meth:`~repro_torch.serve.transfer.
TransferMixin.fetch_finished`; a PREFILL engine's graduation is that
park plus a published handoff record.

Admission takes the chunk queue, or, with ``chunk_tokens`` unset or a
prompt longer than the slot (an SWA ring), the whole-prompt dense
prefill padded to a ``prefill_buckets`` bucket (the dense flash
attention kernel on the card), whose K/V is scattered into the prompt's
pool frames.  With ``paging.enabled=False`` the engine keeps no pool:
a dense per-slot :class:`~repro_torch.models.model.Cache`, dense
prefill into the slot at admission, the slot released at finish.

The host logic (pool, page table, pager, far tier, prefix cache,
virtual clock, scheduling policy) is a copy of the JAX package's, so on
the same weights both engines make the same scheduling decisions.  The
SSM family (rwkv6) has no attention KV, so it is served without a pool,
as in the reference (paging resolves to off); the hybrid family (zamba2)
pages the KV of its shared attention block, and its recurrent state rides
beside it: a whole-prompt prefill at the prompt's exact length (pad
tokens would enter the state), chunks of one exact shape that carry the
state from chunk to chunk, and the state in every park, offload and
handoff residue.  The encoder-decoder family (seamless) runs its encoder
at admission over the request's ``src_embeds`` (the stub frontend's
frame embeddings, cut or zero-padded to the prompt's bucket) and keeps
each slot's cross K/V in ``cache.cross`` beside the pool: the dense
prefill computes it with the prompt, the chunk queue with
:func:`~repro_torch.models.model.encode_cross` before the first chunk
(again at a mid-prefill resume), and a park, offload or handoff carries
it in the residue.  A dense config with experts (and an MoE stack whose
groups do not tile the layers) raises ``NotImplementedError``.

With ``paging.kv_quant`` int8 or fp8 the pool's frames are quantized with
per-(frame, KV head) scales (:mod:`repro_torch.kernels.kv_quant`): a
frame is about half the bytes of a bf16 one, so a byte budget holds
twice the frames and every park or resume moves half the bytes; the
scales ride every page transfer beside the frame's bytes.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_quant import KVQuantConfig
from repro_torch.models.model import (cast_params, family_ported,
                                      init_cache, init_paged_cache,
                                      init_ssm_state, kv_layers, torch_dtype)
from repro_torch.obs import (MetricsRegistry, Tracer, to_chrome_trace,
                             write_chrome_trace, write_metrics)
from repro_torch.paging import (DeadlineQueue, EventKind, EventLoop, PagePool,
                                PageState, PageTable, Pager, PagingError,
                                PrefixCache, WatermarkPolicy, pages_for)
from repro_torch.serve.admission import AdmissionMixin
from repro_torch.serve.config import EngineConfig, EngineRole, Tier, VirtualClock
from repro_torch.serve.decode import DecodeMixin
from repro_torch.serve.disagg import HandoffBoard
from repro_torch.serve.kv_cache import SlotPool
from repro_torch.serve.policy import SCHEDULERS as _SCHEDULERS
from repro_torch.serve.request import Request
from repro_torch.serve.speculate import NgramProposer
from repro_torch.serve.transfer import TransferMixin
from repro_torch.steps import make_mixed_step, make_serve_step

__all__ = ["Request", "Engine"]

#: the K/V pool's dtype without quantization (the JAX package's
#: ``init_paged_kv_cache`` default)
POOL_DTYPE = torch.bfloat16


def _paging(cfg: ModelConfig, pg) -> bool:
    """Whether the engine pages: a family with attention KV, unless the
    caller turns paging off (``repro/serve/engine.py:226-231``)."""
    has_kv = kv_layers(cfg) > 0
    return has_kv if pg.enabled is None else bool(pg.enabled) and has_kv


def _check_quant(cfg: ModelConfig, paging: bool,
                 kv_quant: KVQuantConfig) -> None:
    """The JAX engine's two rules for a quantized pool
    (``repro/serve/engine.py:241-252``), checked first, as there."""
    if not kv_quant.enabled:
        return
    if not paging:
        raise PagingError(
            "kv_quant requires the paged engine: quantized frames live in "
            "the device page pool")
    if cfg.family not in ("dense", "moe") or cfg.attention == "swa":
        raise PagingError(
            "kv_quant supports global-attention dense/moe families "
            "(append-only KV; a SWA ring wrap would rewrite rows under a "
            f"stale frame scale); got family={cfg.family!r} "
            f"attention={cfg.attention!r}")


def _page_nbytes(cfg: ModelConfig, page_size: int,
                kv_quant: KVQuantConfig) -> int:
    """Bytes of one page frame, K + V of every KV layer — the unit the
    pager moves; a quantized frame adds its (L, Hkv) f32 scale pair."""
    L = kv_layers(cfg)
    kv = 2 * L * page_size * cfg.num_kv_heads * cfg.head_dim
    if kv_quant.enabled:
        return int(kv * kv_quant.itemsize + 2 * L * cfg.num_kv_heads * 4)
    return int(kv * POOL_DTYPE.itemsize)


def _check_roles(cfg: ModelConfig, ec: EngineConfig, paging: bool) -> None:
    """The JAX engine's rules for finished-sequence offload, the
    disaggregated roles, the prefix cache and speculation
    (``repro/serve/engine.py:311-320``, ``:378-388``, ``:403-417``),
    checked in its order, before the port's own refusals."""
    pg, ck = ec.paging, ec.chunking
    role = EngineRole(ec.role)
    if pg.offload_finished and not paging:
        raise PagingError(
            "offload_finished requires the paged engine: finished KV is "
            "parked page-by-page through the pager's far tier")
    if role is not EngineRole.FUSED and not paging:
        raise PagingError(
            "disaggregated roles require the paged engine: the "
            "prefill/decode handoff travels through the far tier")
    if ck.prefix_cache:
        if not ck.chunk_tokens or not paging:
            raise PagingError(
                "prefix_cache requires chunked paged admission "
                "(chunk_tokens > 0 on the paged engine)")
        if cfg.family not in ("dense", "moe") or cfg.attention == "swa":
            raise PagingError(
                "prefix_cache supports global-attention dense/moe "
                f"families; got family={cfg.family!r} "
                f"attention={cfg.attention!r}")
    if ec.speculation.speculate_k:
        if not paging:
            raise PagingError(
                "speculative decode requires the paged engine "
                "(verify-K scatters through the page table)")
        if cfg.family not in ("dense", "moe") or cfg.attention == "swa":
            raise PagingError(
                "speculative decode supports global-attention dense/moe "
                f"families; got family={cfg.family!r} "
                f"attention={cfg.attention!r}")
        if role is EngineRole.PREFILL:
            raise PagingError(
                "a PREFILL-role engine never decodes past the first token "
                "— speculation has nothing to draft")


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family the port's engine does not serve yet."""
    if not family_ported(cfg):
        raise NotImplementedError(
            f"not ported to the PyTorch engine yet: family {cfg.family!r} "
            f"with {cfg.num_experts} experts, moe_every {cfg.moe_every}, "
            f"shared_expert {cfg.shared_expert}")


class Engine(AdmissionMixin, TransferMixin, DecodeMixin):
    """Continuous-batching serving engine on the paged far-memory KV.

    Operationally::

        eng = Engine(cfg, params, EngineConfig(
            max_batch=4, max_len=256, device="cuda",
            paging=PagingConfig(page_size=16,
                                device_pages=48),   # oversubscribed
            chunking=ChunkingConfig(chunk_tokens=32)))
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        outputs = eng.run()                           # {rid: tokens}

    ``params`` may live anywhere and be f32: construction moves them to
    ``config.device`` and casts the matrix weights to the compute dtype
    once (tensors already there are not copied).
    """

    def __init__(self, cfg: ModelConfig, params,
                 config: Optional[EngineConfig] = None):
        ec = config or EngineConfig()
        pg, ck, sc = ec.paging, ec.chunking, ec.scheduler
        # quantized paged frames (int8/fp8 + per-(frame, head) scales):
        # resolved up front so the pool dtype, the page byte accounting
        # and the far-tier payloads agree; "none" keeps the bf16 pool with
        # no scale tensors
        self.kv_quant = KVQuantConfig.from_name(pg.kv_quant)
        paging = _paging(cfg, pg)
        _check_quant(cfg, paging, self.kv_quant)
        _check_roles(cfg, ec, paging)
        _check_supported(cfg)
        max_batch, max_len = ec.max_batch, ec.max_len
        self.device = torch.device(ec.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EngineConfig.device='cuda' but no CUDA "
                               "device is available (pass device='cpu')")
        self.config = ec
        self.sched_cfg = sc
        self.cfg = cfg
        self.params = cast_params(params, torch_dtype(cfg.compute_dtype),
                                  self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in ec.prefill_buckets
                                    if b <= max_len)) or (max_len,)
        # ONE clock for every request timestamp: an engine-owned
        # VirtualClock advanced by step_dt per tick, in lockstep with the
        # pager's simulated AMU, unless the caller injects one
        self.clock = sc.clock if sc.clock is not None else VirtualClock()
        self._own_clock = sc.clock is None
        self._admit_now = 0.0     # the instant the last admission read
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(clock=self.clock, enabled=ec.obs.tracing)
        self._phase_span: Dict[int, int] = {}    # rid -> open lifecycle sid
        self._obs_started: set = set()           # rids with a queued span
        self.pool = SlotPool(max_batch)
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}     # slot -> request
        self.finished: Dict[int, Request] = {}
        # a plain counter, so a DECODE engine can bump it past handed-off
        # rids: local submissions and adopted requests share one id space
        self._next_rid = 0
        self._admits = itertools.count()

        # -- page-granularity KV residency over a fixed device pool --------
        # (paged when the family has attention KV, unless the caller
        # turns paging off)
        self.paging = paging
        page_size = pg.page_size
        self.page_size = page_size
        self.step_dt = sc.step_dt
        self.hot_tail_pages = max(0, pg.hot_tail_pages)
        self._resuming: Dict[int, Request] = {}
        if self.paging:
            self._init_pool(cfg, pg)
        else:
            self.slot_tokens = 0
            self.page_pool = self.page_table = self.pager = None
            self.far_tier = None
            self.cache = init_cache(cfg, max_batch, max_len,
                                    device=self.device)
        # -- engine role: which half of the pipeline this assembly runs ----
        self.role = EngineRole(ec.role)
        self.offload_finished = pg.offload_finished
        if self.role is EngineRole.PREFILL:
            # graduation IS an offload_finished park into the (shared)
            # far tier: the role implies the flag
            self.offload_finished = True
        self.handoff = ec.handoff
        if self.role is EngineRole.PREFILL and self.handoff is None:
            self.handoff = HandoffBoard()
        self.policy = pg.watermark or WatermarkPolicy(low=0, critical=0)
        if sc.policy not in _SCHEDULERS:
            raise PagingError(
                f"unknown scheduler policy {sc.policy!r}; "
                f"expected one of {sorted(_SCHEDULERS)}")
        self.sched = _SCHEDULERS[sc.policy](self)
        self.deadlines = DeadlineQueue()

        # -- steps: decode-only, and decode fused with a prompt chunk ------
        self._decode = make_serve_step(cfg, paged=self.paging)
        self.chunk_tokens = int(ck.chunk_tokens) if ck.chunk_tokens else 0
        self.chunk_slots = max(1, int(ck.chunk_slots))
        self.chunking = bool(self.chunk_tokens) and self.paging
        self.prefilling: Dict[int, Request] = {}     # slot -> admitting req
        if self.chunking:
            self._mixed = make_mixed_step(cfg)
            if cfg.family == "hybrid":
                # the carry of a row that starts its prompt, (L, 1, ...)
                self._zero_chunk_ssm = init_ssm_state(cfg, 1,
                                                      device=self.device)

        # -- cross-request prefix sharing (content-addressed prompt pages):
        # supported where the shared KV is position- and content-exact for
        # every sharer — global-attention dense/moe (``_check_roles``)
        self.prefix: Optional[PrefixCache] = None
        if ck.prefix_cache:
            self.prefix = PrefixCache(self.page_pool, self.page_table,
                                      self.pager, page_size)

        # -- draft-free self-speculative decode (verify-K) ------------------
        # an n-gram prompt-lookup proposer drafts up to K tokens per slot
        # from the slot's own committed history; one verify step scores
        # all drafts through the multi-row paged kernel.  Append-only KV
        # and absolute RoPE only: an SWA ring would rewrite rolled-back
        # pages
        sp = ec.speculation
        self.speculate_k = int(sp.speculate_k or 0)
        self.speculating = self.speculate_k > 0
        self.proposer = None
        if self.speculating:
            if sp.proposer_factory is not None:
                self.proposer = sp.proposer_factory(sp.speculate_ngram,
                                                    self.speculate_k)
            else:
                self.proposer = NgramProposer(n=sp.speculate_ngram,
                                              k=self.speculate_k)
            self._verify = make_serve_step(cfg, self.speculate_k)
            if self.chunking:
                self._mixed_verify = make_mixed_step(cfg, self.speculate_k)

        self.events = EventLoop(metrics=self.metrics)
        self.events.on(EventKind.TICK, self._on_tick)
        self.events.on(EventKind.PAGE_ARRIVED, self._on_page_arrived)
        self.events.on(EventKind.COMPLETE, self._on_complete)
        self.events.on(EventKind.DEADLINE, self._on_deadline)
        # dict-compatible view onto the shared registry ("engine" group),
        # seeded with the JAX engine's FUSED keys so snapshots compare
        initial = {"steps": 0, "prefills": 0, "admitted": 0,
                   "preemptions": 0, "resumes": 0, "mixed_steps": 0,
                   "chunks": 0, "prefill_preempts": 0,
                   "prefix_hits": 0, "prefix_tokens_saved": 0,
                   "prefix_far_hits": 0, "deadline_misses": 0,
                   "slo_attained": 0, "slo_missed": 0,
                   "shed_admissions": 0}
        if self.role is not EngineRole.FUSED:
            initial["handoffs"] = 0      # FUSED snapshots stay unchanged
        if self.speculating:
            # seeded only when speculating, so non-speculative counters
            # stay equal to the JAX engine's
            initial.update({"spec_steps": 0, "drafted": 0,
                            "accepted": 0, "rejected": 0})
        self.stats = self.metrics.counters("engine", initial=initial)

    def _init_pool(self, cfg: ModelConfig, pg) -> None:
        """The paged engine's device pool, page table, pager and far tier,
        and the :class:`~repro_torch.models.model.PagedCache` over the
        pool's frames plus the trash frame."""
        max_batch, page_size = self.max_batch, self.page_size
        self.slot_tokens = (min(self.max_len, cfg.window)
                            if cfg.attention == "swa" else self.max_len)
        if self.slot_tokens % page_size:
            raise PagingError(
                f"page_size {page_size} must divide the per-sequence "
                f"token capacity {self.slot_tokens}")
        self.pages_per_seq = self.slot_tokens // page_size
        n_pages = pg.device_pages if pg.device_pages is not None \
            else max_batch * self.pages_per_seq
        nbytes = _page_nbytes(cfg, page_size, self.kv_quant)
        self.page_pool = PagePool(n_pages, page_size)
        self.page_table = PageTable(self.page_pool)
        if pg.pager_factory is not None:
            self.pager = pg.pager_factory(self.page_pool, self.page_table,
                                          page_nbytes=nbytes)
        else:
            self.pager = Pager(self.page_pool, self.page_table,
                               page_nbytes=nbytes)
        if self.pager.read_frame is None:        # keep a factory's hook
            self.pager.read_frame = self._read_frame
        self.pager.bind_obs(self.metrics, self.tracer)
        # THE far tier: one FarMemoryTier behind the pager holds every
        # cold page (preempted or watermark-evicted)
        self.far_tier = self.pager.tier
        # device frames: pool frames + one trash frame at the end
        self.trash_frame = n_pages
        self.cache = init_paged_cache(cfg, max_batch, self.max_len,
                                      n_frames=n_pages + 1,
                                      page_size=page_size,
                                      device=self.device,
                                      quant=self.kv_quant)
        self._pt_np = np.full((max_batch, self.pages_per_seq),
                              self.trash_frame, np.int32)
        self._pt_dirty = True

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               src_embeds: Optional[np.ndarray] = None,
               tier: Tier = Tier.INTERACTIVE,
               ttft_slo: Optional[float] = None,
               tpot_slo: Optional[float] = None,
               arrival_t: Optional[float] = None) -> int:
        """Queue one request.  ``src_embeds`` (S, d_model) is an enc-dec
        request's source, its frame embeddings (zeros when None), ``tier``
        picks the priority class, ``ttft_slo``/``tpot_slo`` override the
        :class:`SchedulerConfig` defaults, and ``arrival_t`` places the
        request on the clock's time axis (the engine admits nothing
        before its arrival)."""
        prompt = np.asarray(prompt, np.int32)
        if not 0 < len(prompt) <= self.max_len:
            raise NotImplementedError(
                f"prompt of {len(prompt)} tokens: the engine serves prompts "
                f"of 1..{self.max_len} tokens (max_len); a longer one "
                "outgrows the dense prefill's largest bucket, max_len, in "
                "the reference too")
        if self.paging:
            # a PREFILL-role engine never decodes: its pool only ever
            # holds the prompt's pages, so the completion horizon is the
            # prompt
            horizon = len(prompt) + (
                0 if self.role is EngineRole.PREFILL else max_new_tokens)
            full = pages_for(min(horizon, self.slot_tokens), self.page_size)
            if full > self.page_pool.n_pages:
                raise PagingError(
                    f"request needs {full} pages; pool has only "
                    f"{self.page_pool.n_pages} — it could never complete")
            # admission only ever needs the prompt's pages (growth is
            # exempt from the low watermark) — reject what can't admit
            admit = pages_for(min(len(prompt), self.slot_tokens),
                              self.page_size)
            if admit + self.policy.low > self.page_pool.n_pages:
                raise PagingError(
                    f"request needs {admit} pages at admission; pool of "
                    f"{self.page_pool.n_pages} under low watermark "
                    f"{self.policy.low} can never admit it")
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      src_embeds=src_embeds, submitted_t=now,
                      tier=Tier(tier),
                      ttft_slo=(ttft_slo if ttft_slo is not None
                                else self.sched_cfg.ttft_slo),
                      tpot_slo=(tpot_slo if tpot_slo is not None
                                else self.sched_cfg.tpot_slo),
                      arrival_t=now if arrival_t is None else arrival_t)
        self.queue.append(req)
        self.sched.on_submit(req)
        return rid

    @property
    def drained(self) -> bool:
        """No work anywhere: queue, batch, chunk queue and resume set
        all empty."""
        return not (self.queue or self.active or self._resuming
                    or self.prefilling)

    def step_once(self) -> None:
        """One iteration of the serving loop: admit, step, tick, and the
        stall handling that keeps the loop progressing."""
        self._admit()
        if self.active or self.prefilling:
            self._step()
        self.events.tick()
        if not self.active and not self.prefilling and self._resuming:
            # nothing decodable: land the in-flight pages, then
            # demand-fetch the head resume so the loop always progresses
            for req in list(self._resuming.values()):
                self.pager.wait_arriving(req.rid)
            self.pager.wait_seq(next(iter(self._resuming.values())).rid)
            self._admit()
        if not self.active and not self.prefilling \
                and not self._resuming and self.queue:
            # everything just finished this step: retry admission now
            self._admit()
            if not self.active and not self.prefilling \
                    and not self._resuming:
                # "not arrived" as the admission saw it: an injected
                # wall clock may pass an arrival after that read, and the
                # next step admits that request
                future = [r.arrival_t for r in self.queue
                          if r.arrival_t > self._admit_now]
                if future and len(future) == len(self.queue):
                    # idle only because the trace is: fast-forward the
                    # virtual clock to the next arrival
                    if self._own_clock:
                        self.clock.advance(max(0.0, min(future)
                                               - self.clock()))
                    return
                free = self.page_pool.n_free if self.paging else "n/a"
                raise PagingError(
                    f"{len(self.queue)} queued requests can never be "
                    f"admitted (free pages {free}, "
                    f"low watermark {self.policy.low})")

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Event loop until every submitted request completes; returns
        ``{rid: generated tokens}``."""
        for _ in range(max_steps):
            if self.drained:
                break
            self.step_once()
        if self.drained:
            self.check_invariants()     # the telemetry counters balance
        ob = self.config.obs
        if ob.trace_out:
            self.export_trace(ob.trace_out)
        if ob.metrics_out:
            self.export_metrics(ob.metrics_out)
        return {r.rid: r.generated for r in self.finished.values()}

    # -- event handlers -------------------------------------------------------
    def _on_tick(self, ev) -> None:
        # the engine-owned virtual clock advances here, by step_dt, in
        # lockstep with the pager's simulated backend below
        if self._own_clock:
            self.clock.advance(self.step_dt)
        for t, rid in self.deadlines.pop_due(self.clock()):
            self.events.post(EventKind.DEADLINE, (t, rid))
        if self.pager is None:
            return
        for seq, logical in self.pager.advance(self.step_dt):
            self.events.post(EventKind.PAGE_ARRIVED, (seq, logical))
        # capacity pressure: push cold RESIDENT pages to the far tier
        # now, so the BULK astores overlap decode
        if self.policy.low:
            self.pager.balance(self.policy.low)

    def _on_page_arrived(self, ev) -> None:
        seq, logical = ev.payload
        pte = self.page_table.entry(seq, logical)
        if pte.state is PageState.RESIDENT:
            self._land_frame(pte.phys)       # copy into the device pool
            self.page_pool.touch(pte.phys)

    def _on_complete(self, ev) -> None:
        rid = ev.payload
        if self.paging and rid in self.page_table.sequences():
            self.page_table.drop(rid)
            if not self.offload_finished:
                # offloaded sequences keep their far-tier pages: that IS
                # the store fetch_finished (or a DECODE peer) reads back
                self.pager.drop_far(rid)

    def _on_deadline(self, ev) -> None:
        """A TTFT deadline passed: a request still without a first token
        has missed its SLO *now*."""
        t, rid = ev.payload
        req = self.finished.get(rid)
        if req is None:
            for r in itertools.chain(self.queue, self.active.values(),
                                     self.prefilling.values(),
                                     self._resuming.values()):
                if r.rid == rid:
                    req = r
                    break
        if req is not None and not req.token_ts:
            self.stats["deadline_misses"] += 1
            if self.tracer.enabled:
                self.tracer.instant("engine", "sched", "deadline_miss",
                                    {"rid": rid, "tier": req.tier.name,
                                     "deadline": t})

    # -- telemetry ------------------------------------------------------------
    def _obs_phase(self, req: Request, name: Optional[str]) -> None:
        """Advance a request's lifecycle track: close its current phase
        span and open ``name`` (None just closes — the finish path)."""
        tr = self.tracer
        if not tr.enabled:
            return
        tid = f"req{req.rid}"
        if req.rid not in self._obs_started:
            self._obs_started.add(req.rid)
            tr.complete("requests", tid, "queued", req.arrival_t,
                        args={"tier": req.tier.name})
        tr.end(self._phase_span.pop(req.rid, 0))
        if name is not None:
            self._phase_span[req.rid] = tr.begin(
                "requests", tid, name, {"tier": req.tier.name})

    def check_invariants(self) -> None:
        """Cross-layer conservation checks over the telemetry counters:
        speculating, accepted + rejected == drafted (every drafted token
        is adjudicated once) and no active slot's valid tokens exceed its
        mapped frames; preemptions == resumes + requests currently
        parked by a preemption (a prefix-far admission or a handoff
        parks without one); ADMIT events == admissions + resumes; on a
        PREFILL role, HANDOFF events == published handoffs; the pager's
        per-QoS window accounting balances (see
        :meth:`Pager.check_invariants`)."""
        s = self.stats
        if self.speculating:
            if s["accepted"] + s["rejected"] != s["drafted"]:
                raise PagingError(
                    f"speculation imbalance: {s['accepted']} accepted + "
                    f"{s['rejected']} rejected != {s['drafted']} drafted")
            pos_np = self.cache.pos.cpu().numpy()
            for slot, req in self.active.items():
                covered = self.page_table.n_pages(req.rid) * self.page_size
                if int(pos_np[slot]) > covered:
                    raise PagingError(
                        f"rid {req.rid}: valid tokens {int(pos_np[slot])} "
                        f"exceed scattered frames ({covered} positions "
                        "mapped)")
        pending = sum(
            1 for r in itertools.chain(self.queue, self._resuming.values())
            if r.parked and r.n_preempts > 0)
        if s["preemptions"] != s["resumes"] + pending:
            raise PagingError(
                f"preempt/resume imbalance: {s['preemptions']} preemptions "
                f"!= {s['resumes']} resumes + {pending} currently parked")
        admits = self.events.history.get(EventKind.ADMIT, 0)
        if admits != s["admitted"] + s["resumes"]:
            raise PagingError(
                f"ADMIT event imbalance: {admits} events != "
                f"{s['admitted']} admissions + {s['resumes']} resumes")
        if self.role is EngineRole.PREFILL:
            hoffs = self.events.history.get(EventKind.HANDOFF, 0)
            if hoffs != s["handoffs"]:
                raise PagingError(
                    f"HANDOFF event imbalance: {hoffs} events != "
                    f"{s['handoffs']} published handoffs")
        if self.pager is not None:
            self.pager.check_invariants()

    def export_trace(self, path: Optional[str] = None) -> dict:
        """Chrome-trace/Perfetto JSON of everything traced so far (AMU
        transfers, pager actions, request lifecycle — one virtual time
        axis).  Writes to ``path`` when given."""
        if path is not None:
            write_chrome_trace(path, self.tracer, metrics=self.metrics)
        return to_chrome_trace(self.tracer, metrics=self.metrics)

    def export_metrics(self, path: Optional[str] = None) -> dict:
        """Flat JSON snapshot of every counter/gauge/histogram."""
        if path is not None:
            write_metrics(path, self.metrics)
        return self.metrics.snapshot()
