"""Deterministic serving-policy simulation over the paging subsystem.

Compares, on the SimBackend's virtual clock, the two KV-transfer
policies the paper contrasts:

  * **blocking whole-sequence fetch** — the seed engine's pattern: one
    coarse AMU request for a sequence's entire KV, waited on before any
    of its tokens decode (transfer and compute strictly serialized),
  * **AMU prefetching pager** — page-granularity LATENCY-QoS aloads of
    the *next* sequence's KV issued while the current one decodes, LRU
    eviction of clean pages for free, BULK writeback of the dirty tail.

Everything runs through the real :class:`~repro_torch.paging.Pager` /
:class:`~repro_torch.paging.PagePool` / :class:`~repro_torch.paging.EventLoop`
against a simulated-latency AMU, so the numbers are deterministic and
the benchmark doubles as an integration test of the subsystem.

A copy of the JAX package's ``repro.paging.sim`` on this package's
paging stack: the seven entry points give the reference's dicts key for
key, except :func:`simulate_spec_decode`, whose synthetic streams are
seeded differently (see its docstring).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.amu import AMU, AccessConfig, QoS, SimBackend
from repro_torch.paging.events import EventKind, EventLoop
from repro_torch.paging.page_table import PagePool, PageState, PageTable
from repro_torch.paging.pager import Pager

__all__ = ["kv_page_nbytes", "simulate_paged_serving",
           "simulate_mixed_batching", "simulate_prefix_reuse",
           "simulate_slo_schedule", "simulate_disagg",
           "simulate_spec_decode"]


def kv_page_nbytes(page_size: int = 16, n_layers: int = 32,
                   kv_heads: int = 8, head_dim: int = 16, *,
                   itemsize: int = 2,
                   scale_bytes_per_head: int = 0) -> int:
    """Bytes one paged KV frame moves over the AMU — the transfer-cost
    model every page-granularity sim sweep shares.

    Mirrors the engine's ``page_nbytes`` accounting exactly: K and V
    payloads at the pool dtype (``2 * L * page * Hkv * D * itemsize``)
    plus, for a quantized pool, the per-(layer, head) scale pair that
    rides every transfer (``2 * L * Hkv * scale_bytes_per_head``).  The
    defaults reproduce the historical 256 KiB page of
    :func:`simulate_paged_serving`; a quantized sweep passes
    ``itemsize=1, scale_bytes_per_head=4`` for int8/fp8 frames."""
    payload = 2 * n_layers * page_size * kv_heads * head_dim * itemsize
    scales = 2 * n_layers * kv_heads * scale_bytes_per_head
    return int(payload + scales)


def simulate_paged_serving(
    oversubscription: float,
    *,
    n_seqs: int = 8,
    pages_per_seq: int = 8,
    page_bytes: int = 256 << 10,
    new_tokens: int = 32,
    tick_s: float = 5e-6,
    base_latency: float = 10e-6,
    bandwidth: float = 10e9,
    latency_window: int = 8,
    densify_bandwidth: float = 20e9,
    tracer=None,
    metrics=None,
) -> Dict[str, float]:
    """Serve ``n_seqs`` decode bursts whose KV starts in the far tier,
    with the device pool sized to ``total_pages / oversubscription``.
    Returns virtual-clock timings for both policies plus the pager's
    page hit rate (fraction of pages already resident when a burst
    starts — prefetch that landed in time).

    Also models the *densification tax* the engine paid before decode
    computed on the paged layout directly: every sequence activation
    used to join its pages into a contiguous slot buffer and insert it
    into the batched cache (one full-sequence copy at
    ``densify_bandwidth``), and parking extracted it back out.  The
    ``paged_densify_*`` keys are the paged policy *with* that copy-in/
    copy-out; ``speedup`` (paged, no densification — what the engine
    does now) vs ``speedup_densify`` quantifies what eliminating the
    round-trip buys at the serving level."""
    total_pages = n_seqs * pages_per_seq
    pool_pages = max(pages_per_seq, int(round(total_pages / oversubscription)))
    seq_bytes = pages_per_seq * page_bytes
    total_tokens = n_seqs * new_tokens

    # -- policy 1: blocking whole-sequence fetch ---------------------------
    be = SimBackend(base_latency=base_latency, bandwidth=bandwidth)
    amu = AMU(backend=be, max_outstanding=4)
    cfg = AccessConfig(granularity_bytes=seq_bytes, qos=QoS.STANDARD)
    t0 = be.now
    for _ in range(n_seqs):
        amu.wait(amu.aload(nbytes=seq_bytes, config=cfg))
        be.advance(new_tokens * tick_s)
    blocking_time = be.now - t0

    # -- policy 2: AMU prefetching pager -----------------------------------
    pool = PagePool(pool_pages, page_size=1)
    table = PageTable(pool)
    sim_be = SimBackend(base_latency=base_latency, bandwidth=bandwidth)
    pamu = AMU(backend=sim_be, max_outstanding=latency_window + 4)
    if tracer is not None:
        tracer.clock = lambda: sim_be.now    # spans on the sim clock
    pager = Pager(pool, table, pamu, page_nbytes=page_bytes,
                  latency_window=latency_window, bulk_window=4,
                  tracer=tracer, metrics=metrics)
    loop = EventLoop(metrics=metrics)
    loop.on(EventKind.PAGE_ARRIVED,
            lambda ev: pool.touch(table.entry(*ev.payload).phys))
    for s in range(n_seqs):
        table.register_parked(s, pages_per_seq)
        for l in range(pages_per_seq):
            pager.store_far(s, l, None)

    hits = 0
    t0 = pamu.backend.now
    for s in range(n_seqs):
        hits += len(table.logical_pages(s, PageState.RESIDENT))
        pager.wait_seq(s)                       # demand-fetch the misses
        pinned = []
        for l in range(pages_per_seq):
            phys = table.entry(s, l).phys
            pool.pin(phys)
            pool.touch(phys)
            pinned.append(phys)
        nxt = s + 1
        for _ in range(new_tokens):             # decode burst
            if nxt < n_seqs:
                short = len(table.logical_pages(nxt, PageState.PARKED))
                if short and pool.n_free < short:
                    pager.evict_lru(short - pool.n_free)
                pager.prefetch_seq(nxt, tail_first=True)
            for arrived in pager.advance(tick_s):
                loop.post(EventKind.PAGE_ARRIVED, arrived)
            loop.tick()
        for phys in pinned:
            pool.unpin(phys)
        pool.mark_dirty(pinned[-1])             # decode wrote the tail page
    paged_time = pamu.backend.now - t0

    # densification tax of the pre-paged-decode engine: one whole-sequence
    # join on every activation and one extract on every deactivation
    # (2 x seq_bytes of device copies per sequence served).
    densify_time = n_seqs * 2 * seq_bytes / densify_bandwidth
    paged_densify_time = paged_time + densify_time

    return {
        "oversubscription": oversubscription,
        "pool_pages": pool_pages,
        "blocking_time": blocking_time,
        "paged_time": paged_time,
        "speedup": blocking_time / paged_time,
        "hit_rate": hits / total_pages,
        "blocking_us_per_token": blocking_time / total_tokens * 1e6,
        "paged_us_per_token": paged_time / total_tokens * 1e6,
        "paged_densify_us_per_token": paged_densify_time / total_tokens * 1e6,
        "speedup_densify": blocking_time / paged_densify_time,
        "densify_eliminated_frac": densify_time / paged_densify_time,
        "bulk_writebacks": pager.stats["writeback"],
        "clean_evictions": pager.stats["clean_evict"],
        "demand_fetches": pager.stats["demand_fetch"],
    }


def simulate_mixed_batching(
    oversubscription: float,
    *,
    max_batch: int = 4,
    prompt_tokens: int = 128,
    new_tokens: int = 32,
    page_size: int = 16,
    chunk_tokens: int = 8,
    chunk_slots: int = 2,
    low_watermark: int = 1,
    t_decode_step: float = 20e-6,
    t_prefill_token: float = 1.5e-6,
) -> Dict[str, float]:
    """Serial dense prefill vs chunked continuous batching, deterministic.

    ``oversubscription`` here is *request* oversubscription — offered
    load versus slot capacity: ``oversubscription * max_batch * 4``
    requests arrive at t=0 against ``max_batch`` decode slots (the
    page-pool oversubscription axis is ``paged_kv_sweep``'s job; this
    bench isolates the admission bubble, so the pool holds every slot's
    working set with watermark headroom).  Two admission policies over
    one virtual clock:

    * **serial dense prefill** — the pre-chunking engine: admitting a
      request stalls *every* running slot for the whole prompt's
      prefill (``prompt_tokens * t_prefill_token``), then decode
      resumes: transfer^W prefill and decode strictly serialized, the
      admission-bubble analogue of the paper's blocking far-memory
      access (§1),
    * **chunked mixed steps** — the chunk-queue engine: each step runs
      one decode token for every running slot *fused* with up to
      ``chunk_slots`` prompt chunks.  Decode steps are memory-bound on
      weight traffic while a prompt chunk is compute-dense, so the
      fused step costs ``max(t_decode_step, chunk_work)`` — the chunk
      FLOPs hide under the decode step's weight streaming exactly as
      the AMU hides far-memory latency under compute (the overlap
      thesis at serving granularity; 2404.11044 makes the same case
      for massive request-level parallelism).

    Returns mean/p95 time-to-first-token and decode tokens/s for both
    policies; ``ttft_speedup > 1`` means chunking improved mean TTFT.
    """
    n_seqs = max(1, int(round(oversubscription * max_batch * 4)))
    pages_per_seq = -(-(prompt_tokens + new_tokens) // page_size)
    pool_pages = max_batch * pages_per_seq + low_watermark

    def admission_pages(decoded: int) -> int:
        return -(-prompt_tokens // page_size) if decoded == 0 else \
            -(-(prompt_tokens + decoded + 1) // page_size)

    def run(chunked: bool) -> Dict[str, float]:
        now = 0.0
        free_pages = pool_pages
        queue = list(range(n_seqs))
        running: Dict[int, int] = {}        # seq -> decoded tokens
        prefilling: Dict[int, int] = {}     # seq -> prefilled tokens
        held: Dict[int, int] = {}           # seq -> pages held
        ttft = [0.0] * n_seqs
        done = 0
        decode_steps = 0
        decode_time = 0.0
        while done < n_seqs:
            # admit while slots + pages-above-watermark allow
            while queue and (len(running) + len(prefilling)) < max_batch:
                need = -(-prompt_tokens // page_size)
                if free_pages - need < low_watermark:
                    break
                seq = queue.pop(0)
                free_pages -= need
                held[seq] = need
                if chunked:
                    prefilling[seq] = 0
                else:
                    now += prompt_tokens * t_prefill_token  # global stall
                    ttft[seq] = now
                    running[seq] = 1        # first token from prefill
            if not running and not prefilling:
                break
            # one engine step
            chunk_work = 0
            if chunked:
                for seq in sorted(prefilling)[:chunk_slots]:
                    take = min(chunk_tokens,
                               prompt_tokens - prefilling[seq])
                    prefilling[seq] += take
                    chunk_work += take
                step = max(t_decode_step if running else 0.0,
                           chunk_work * t_prefill_token)
                step = step or t_decode_step
            else:
                step = t_decode_step
            now += step
            if running:
                decode_steps += 1
                decode_time += step
            for seq in sorted(prefilling):
                if prefilling[seq] >= prompt_tokens:
                    del prefilling[seq]
                    ttft[seq] = now
                    running[seq] = 1
            for seq in sorted(running):
                # grow a page at each boundary (skip when pool is dry:
                # the modeled engine preempts; we charge no extra time)
                need = admission_pages(running[seq]) - held[seq]
                if need > 0 and free_pages >= need:
                    free_pages -= need
                    held[seq] += need
                running[seq] += 1
                if running[seq] >= new_tokens:
                    free_pages += held.pop(seq)
                    del running[seq]
                    done += 1
        total_new = n_seqs * new_tokens
        ttft_sorted = sorted(ttft)
        return {
            "ttft_mean": sum(ttft) / n_seqs,
            "ttft_p95": ttft_sorted[min(n_seqs - 1,
                                        int(0.95 * n_seqs))],
            "wall": now,
            "decode_tok_per_s": total_new / now,
            "decode_steps": decode_steps,
            # mean decode-step cost = inter-token latency: chunk work
            # stretches a mixed step to max(t_decode_step, chunk FLOPs)
            "tpot_mean": decode_time / max(1, decode_steps),
        }

    dense = run(chunked=False)
    mixed = run(chunked=True)
    return {
        "oversubscription": oversubscription,
        "pool_pages": pool_pages,
        "ttft_dense_us": dense["ttft_mean"] * 1e6,
        "ttft_mixed_us": mixed["ttft_mean"] * 1e6,
        "ttft_p95_dense_us": dense["ttft_p95"] * 1e6,
        "ttft_p95_mixed_us": mixed["ttft_p95"] * 1e6,
        "ttft_speedup": dense["ttft_mean"] / mixed["ttft_mean"],
        "tok_per_s_dense": dense["decode_tok_per_s"],
        "tok_per_s_mixed": mixed["decode_tok_per_s"],
        "throughput_speedup": (mixed["decode_tok_per_s"]
                               / dense["decode_tok_per_s"]),
        "tpot_dense_us": dense["tpot_mean"] * 1e6,
        "tpot_mixed_us": mixed["tpot_mean"] * 1e6,
    }


def simulate_spec_decode(
    oversubscription: float,
    *,
    traffic: str = "repetitive",
    max_batch: int = 4,
    prompt_tokens: int = 64,
    new_tokens: int = 48,
    speculate_k: int = 4,
    ngram: int = 3,
    period: int = 8,
    vocab: int = 512,
    seed: int = 0,
    t_decode_step: float = 20e-6,
    t_prefill_token: float = 1.5e-6,
    c_verify: float = 0.15,
) -> Dict[str, float]:
    """Self-speculative verify-K decode vs single-step, deterministic.

    A burst of ``oversubscription * max_batch * 4`` requests is served
    on ``max_batch`` decode slots over a virtual clock; each request's
    *true* token stream is synthetic and known up front, so greedy
    acceptance is exact prefix matching against it — the same algebra
    the engine's verify step runs against argmax logits.  Two traffic
    shapes:

    * ``"repetitive"`` — each stream cycles a per-request random
      ``period``-gram, the prompt-lookup proposer's best case (code,
      templated text); trailing n-grams recur, so drafts are nearly
      always the true continuation,
    * ``"adversarial"`` — i.i.d. uniform random tokens; with a large
      vocabulary the trailing n-gram essentially never recurs, so the
      proposer rarely fires and almost nothing it drafts survives.

    Drafting uses the REAL :class:`~repro_torch.serve.speculate.NgramProposer`
    over each request's prompt + generated history, not a model of it.
    A speculative step's cost scales with the widest draft actually
    batched that step — the verify matmul's extra query rows —
    ``t_decode_step * (1 + c_verify * K_step)``, and each slot advances
    ``1 + accepted``; the single-step baseline pays ``t_decode_step``
    per token.  Pages are not the constraint here (that is
    ``paged_kv_sweep``); admission is slot-bound with serial prefill on
    both sides, so the ratio isolates verify-K compression.

    Returns tokens/s for both policies, the throughput speedup, and
    mean accepted-K per drafting slot (the acceptance telemetry the
    engine reports from its ``spec_*`` tracks).

    Each request's stream draws from ``random.Random(f"{seed}:{traffic}:
    {s}")``: a string seed goes through SHA-512, so the streams are the
    same in every process whatever ``PYTHONHASHSEED`` says.  The JAX
    package seeds ``random.Random((seed, traffic, s))`` with a tuple,
    which Python 3.11 and later refuse (``TypeError``) and which earlier
    versions hashed per process; so this function's streams, and its
    dict, are its own and are not the reference's.
    """
    import random as _random

    from repro_torch.serve.speculate import NgramProposer

    if traffic not in ("repetitive", "adversarial"):
        raise ValueError(f"unknown traffic shape {traffic!r}")
    n_seqs = max(1, int(round(oversubscription * max_batch * 4)))
    total_len = prompt_tokens + new_tokens
    streams = []
    for s in range(n_seqs):
        rng = _random.Random(f"{seed}:{traffic}:{s}")
        if traffic == "repetitive":
            pattern = [rng.randrange(vocab) for _ in range(period)]
            streams.append([pattern[i % period] for i in range(total_len)])
        else:
            streams.append([rng.randrange(vocab) for _ in range(total_len)])

    def run(speculative: bool) -> Dict[str, float]:
        now = 0.0
        queue = list(range(n_seqs))
        running: Dict[int, int] = {}        # seq -> tokens generated
        proposer = NgramProposer(n=ngram, k=speculate_k)
        drafted = accepted = spec_steps = n_drafts = 0
        done = 0
        while done < n_seqs:
            while queue and len(running) < max_batch:
                seq = queue.pop(0)
                now += prompt_tokens * t_prefill_token  # serial prefill
                running[seq] = 0
            k_step = 0
            advances: Dict[int, int] = {}
            for seq in sorted(running):
                gen = running[seq]
                budget = new_tokens - gen - 1
                adv = 1
                if speculative and budget > 0:
                    hist = streams[seq][:prompt_tokens + gen]
                    draft = proposer.propose(seq, hist)[:budget]
                    if draft:
                        true_tail = streams[seq][prompt_tokens + gen:]
                        acc = 0
                        while acc < len(draft) \
                                and draft[acc] == true_tail[acc]:
                            acc += 1
                        drafted += len(draft)
                        accepted += acc
                        n_drafts += 1
                        k_step = max(k_step, len(draft))
                        adv = 1 + acc
                advances[seq] = adv
            now += t_decode_step * (1.0 + c_verify * k_step)
            if k_step:
                spec_steps += 1
            for seq, adv in advances.items():
                running[seq] += adv
                if running[seq] >= new_tokens:
                    del running[seq]
                    proposer.drop(seq)
                    done += 1
        return {
            "wall": now,
            "tok_per_s": n_seqs * new_tokens / now,
            "drafted": drafted,
            "accepted": accepted,
            "spec_steps": spec_steps,
            "n_drafts": n_drafts,
        }

    plain = run(speculative=False)
    spec = run(speculative=True)
    return {
        "oversubscription": oversubscription,
        "n_seqs": float(n_seqs),
        "tok_per_s_plain": plain["tok_per_s"],
        "tok_per_s_spec": spec["tok_per_s"],
        "throughput_speedup": spec["tok_per_s"] / plain["tok_per_s"],
        "drafted": float(spec["drafted"]),
        "accepted": float(spec["accepted"]),
        "mean_accepted_k": (spec["accepted"] / spec["n_drafts"]
                            if spec["n_drafts"] else 0.0),
        "acceptance_rate": (spec["accepted"] / spec["drafted"]
                            if spec["drafted"] else 0.0),
    }


def simulate_disagg(
    oversubscription: float,
    *,
    max_batch: int = 4,
    prompt_tokens: int = 128,
    new_tokens: int = 32,
    page_size: int = 16,
    chunk_tokens: int = 8,
    chunk_slots: int = 2,
    low_watermark: int = 1,
    t_decode_step: float = 20e-6,
    t_prefill_token: float = 1.5e-6,
    page_bytes: int = 256 << 10,
    base_latency: float = 10e-6,
    bandwidth: float = 10e9,
) -> Dict[str, float]:
    """Two-pool disaggregated prefill/decode vs fused mixed batching, at
    matched device counts, deterministic.

    Both sides get **two devices** and the same offered load
    (``oversubscription * max_batch * 4`` requests *per device*, all at
    t=0):

    * **fused** — two independent ``make_mixed_step`` engines, each
      taking half the traffic: every step fuses one decode token per
      running slot with up to ``chunk_slots`` prompt chunks, so chunk
      FLOPs stretch decode steps (``max(t_decode_step, chunk_work)``)
      and decode slots throttle prefill throughput — the interference
      disaggregation removes,
    * **disaggregated** — one PREFILL device + one DECODE device over a
      shared far tier.  The prefill device runs prompts back-to-back at
      full compute density (no decode interference) and emits each
      request's **first token itself** (the engine's PREFILL role
      finishes at first token), then graduates: a BULK astore parks the
      prompt's KV pages + aux residue in the shared tier
      (``base_latency + pages * page_bytes / bandwidth``, overlapped
      with the next prompt's compute).  The decode device admits each
      handoff through a LATENCY fetch of those pages — overlapped with
      its running decode batch, exactly like the engine's resume
      machinery — and decodes the remaining tokens at an *unstretched*
      ``t_decode_step`` (no chunk work in its steps).

    The trade this exposes is the one production disaggregation is
    deployed for: the fused engines win raw TTFT and aggregate
    throughput at these scales (chunking already hides prefill FLOPs
    under decode weight streaming, and two fused devices prefill two
    prompt streams in parallel), while the disaggregated split wins
    **inter-token latency** — the decode device's steps are never
    stretched by chunk work, so TPOT is flat ``t_decode_step`` instead
    of ``max(t_decode_step, chunk_work)`` whenever prompts are in
    flight.  Returns mean TTFT, mean TPOT and aggregate decode
    tokens/s for both sides; ``ttft_ratio`` / ``tpot_ratio`` /
    ``goodput_ratio`` are oriented so > 1 always means disaggregation
    won that axis.
    """
    per_dev = max(1, int(round(oversubscription * max_batch * 4)))
    n_seqs = 2 * per_dev
    pages = -(-prompt_tokens // page_size)
    xfer = base_latency + pages * page_bytes / bandwidth

    # -- fused baseline: one engine's mixed-batching loop, half traffic
    # (the second device is identical and independent)
    fused = simulate_mixed_batching(
        oversubscription, max_batch=max_batch,
        prompt_tokens=prompt_tokens, new_tokens=new_tokens,
        page_size=page_size, chunk_tokens=chunk_tokens,
        chunk_slots=chunk_slots, low_watermark=low_watermark,
        t_decode_step=t_decode_step, t_prefill_token=t_prefill_token)
    fused_ttft = fused["ttft_mixed_us"] * 1e-6
    fused_tpot = fused["tpot_mixed_us"] * 1e-6
    fused_tok_s = 2 * fused["tok_per_s_mixed"]        # two devices

    # -- disaggregated: prefill device serialises every prompt ---------
    # (dense full-compute prefill + the first-token step; graduation's
    # BULK park overlaps the next prompt)
    now = 0.0
    ttft = []
    ready = []                   # handoff visible to the decode side at
    for _ in range(n_seqs):      # first-token time + BULK park
        now += prompt_tokens * t_prefill_token + t_decode_step
        ttft.append(now)
        ready.append(now + xfer)

    # -- decode device: admit handoffs through a LATENCY fetch that
    # overlaps the running batch, then pure decode steps
    t = 0.0
    remaining = {i: new_tokens - 1 for i in range(n_seqs)}
    running: Dict[int, int] = {}
    nxt = 0
    decoded = 0
    while remaining or running:
        while nxt < n_seqs and len(running) < max_batch:
            # fetch overlaps decode: the admission lands at whichever is
            # later of "pages arrived" and "a step boundary passed"
            at = ready[nxt] + xfer
            if at > t and running:
                break            # keep decoding; admit once it lands
            t = max(t, at)
            running[nxt] = remaining.pop(nxt)
            nxt += 1
        if not running:
            if nxt < n_seqs:
                t = max(t, ready[nxt] + xfer)
                continue
            break
        t += t_decode_step       # one unstretched decode step, all slots
        decoded += len(running)
        for seq in sorted(running):
            running[seq] -= 1
            if running[seq] <= 0:
                del running[seq]
    disagg_ttft = sum(ttft) / n_seqs
    # aggregate completion: first tokens on the prefill device, the rest
    # on the decode device; the decode device finishes last
    wall = max(t, ttft[-1])
    disagg_tok_s = n_seqs * new_tokens / wall

    return {
        "oversubscription": oversubscription,
        "n_seqs": n_seqs,
        "handoff_xfer_us": xfer * 1e6,
        "ttft_fused_us": fused_ttft * 1e6,
        "ttft_disagg_us": disagg_ttft * 1e6,
        "ttft_ratio": fused_ttft / disagg_ttft,
        # the decode device's steps are never stretched by chunk work
        "tpot_fused_us": fused_tpot * 1e6,
        "tpot_disagg_us": t_decode_step * 1e6,
        "tpot_ratio": fused_tpot / t_decode_step,
        "tok_per_s_fused": fused_tok_s,
        "tok_per_s_disagg": disagg_tok_s,
        "goodput_ratio": disagg_tok_s / fused_tok_s,
    }


def simulate_prefix_reuse(
    shared_frac: float,
    *,
    oversubscription: float = 2.0,
    max_batch: int = 4,
    prefix_tokens: int = 240,
    tail_tokens: int = 16,
    new_tokens: int = 32,
    page_size: int = 16,
    chunk_tokens: int = 16,
    chunk_slots: int = 2,
    low_watermark: int = 1,
    t_decode_step: float = 20e-6,
    t_prefill_token: float = 2.5e-6,
    t_page_fetch: float = 15e-6,
) -> Dict[str, float]:
    """Cross-request prefix sharing vs recompute-everything, deterministic.

    Models system-prompt traffic at ``oversubscription`` x request load:
    ``shared_frac`` of the burst's requests carry an identical
    ``prefix_tokens``-long prefix ahead of a unique tail (defaults: a
    240-token system prompt over a 16-token user turn — the
    thousands-of-users-one-template regime prefix caching targets,
    with prompt chunks compute-dense next to the memory-bound decode
    step).  Both engines
    are the chunk-queue engine of :func:`simulate_mixed_batching`; the
    *sharing* engine additionally runs the
    :mod:`repro_torch.paging.prefix_cache` policy:

    * the first shared request to finish its prefix chunks *interns*
      the full prefix pages,
    * every later shared request maps those pages instead of computing
      them — only the boundary page (the hash covers full pages and the
      first token must still produce logits) and the unique tail pay
      prefill FLOPs,
    * under pool pressure the interned pages are evicted to the far
      tier (clean, for free — the intern writes the far home); a hit
      then pays one overlapped LATENCY page-fetch round
      (``t_page_fetch``, all pages under one window) before its first
      chunk instead of the chunks themselves.

    This is the serving-level aggregation claim of the follow-up AMU
    paper (2404.11044): far memory plus massive outstanding aloads
    turns recomputation into cheap overlappable transfers.  Returns
    mean/p95 TTFT for both engines, the TTFT speedup, and the fraction
    of prefill FLOPs the sharing engine skipped.
    """
    n_seqs = max(1, int(round(oversubscription * max_batch * 4)))
    n_shared = int(round(shared_frac * n_seqs))
    prompt_tokens = prefix_tokens + tail_tokens
    pages_per_seq = -(-(prompt_tokens + new_tokens) // page_size)
    pool_pages = max_batch * pages_per_seq + low_watermark
    # full pages only, and the last prompt token always recomputes
    hit_tokens = min(((prefix_tokens - 1) // page_size) * page_size,
                     ((prompt_tokens - 1) // page_size) * page_size)
    hit_pages = hit_tokens // page_size

    def run(sharing: bool) -> Dict[str, float]:
        now = 0.0
        free_pages = pool_pages
        queue = list(range(n_seqs))          # seq < n_shared: shared prefix
        running: Dict[int, int] = {}         # seq -> decoded tokens
        prefilling: Dict[int, int] = {}      # seq -> prefilled tokens
        ready_at: Dict[int, float] = {}      # far-hit fetch completion time
        held: Dict[int, int] = {}
        ttft = [0.0] * n_seqs
        done = 0
        interned = False
        prefill_tokens_done = 0
        far_hit_admissions = 0
        while done < n_seqs:
            while queue and (len(running) + len(prefilling)) < max_batch:
                need = -(-prompt_tokens // page_size)
                if free_pages - need < low_watermark:
                    break
                seq = queue.pop(0)
                shared = seq < n_shared
                start = 0
                if sharing and shared and interned and hit_pages:
                    start = hit_tokens
                    # interned pages resident only while the pool has
                    # slack; at real oversubscription they live in the
                    # far tier and the hit pays one overlapped fetch
                    if free_pages - need < hit_pages + low_watermark:
                        ready_at[seq] = now + t_page_fetch
                        far_hit_admissions += 1
                free_pages -= need
                held[seq] = need
                prefilling[seq] = start
            if not running and not prefilling:
                break
            chunk_work = 0
            for seq in sorted(prefilling)[:chunk_slots]:
                if ready_at.get(seq, 0.0) > now:
                    continue                 # pages still arriving
                take = min(chunk_tokens, prompt_tokens - prefilling[seq])
                prefilling[seq] += take
                chunk_work += take
            step = max(t_decode_step if running else 0.0,
                       chunk_work * t_prefill_token)
            step = step or t_decode_step
            now += step
            prefill_tokens_done += chunk_work
            for seq in sorted(prefilling):
                if prefilling[seq] >= prompt_tokens:
                    del prefilling[seq]
                    ready_at.pop(seq, None)
                    ttft[seq] = now
                    running[seq] = 1
                    if seq < n_shared:
                        interned = True
            for seq in sorted(running):
                need = (-(-(prompt_tokens + running[seq] + 1) // page_size)
                        - held[seq])
                if need > 0 and free_pages >= need:
                    free_pages -= need
                    held[seq] += need
                running[seq] += 1
                if running[seq] >= new_tokens:
                    free_pages += held.pop(seq)
                    del running[seq]
                    done += 1
        ttft_sorted = sorted(ttft)
        return {
            "ttft_mean": sum(ttft) / n_seqs,
            "ttft_p95": ttft_sorted[min(n_seqs - 1, int(0.95 * n_seqs))],
            "wall": now,
            "prefill_tokens": prefill_tokens_done,
            "far_hits": far_hit_admissions,
        }

    plain = run(sharing=False)
    shared = run(sharing=True)
    return {
        "shared_frac": shared_frac,
        "oversubscription": oversubscription,
        "hit_tokens": hit_tokens,
        "ttft_plain_us": plain["ttft_mean"] * 1e6,
        "ttft_shared_us": shared["ttft_mean"] * 1e6,
        "ttft_p95_plain_us": plain["ttft_p95"] * 1e6,
        "ttft_p95_shared_us": shared["ttft_p95"] * 1e6,
        "ttft_speedup": plain["ttft_mean"] / max(shared["ttft_mean"], 1e-30),
        "prefill_tokens_plain": plain["prefill_tokens"],
        "prefill_tokens_shared": shared["prefill_tokens"],
        "prefill_flops_saved_frac": (
            1.0 - shared["prefill_tokens"] / max(1, plain["prefill_tokens"])),
        "far_hits": shared["far_hits"],
        "wall_speedup": plain["wall"] / max(shared["wall"], 1e-30),
    }


def simulate_slo_schedule(
    oversub: float,
    *,
    max_batch: int = 4,
    n_requests: int = 160,
    page_size: int = 16,
    chunk_tokens: int = 16,
    chunk_slots: int = 2,
    low_watermark: int = 1,
    batch_headroom: int = 2,
    t_decode_step: float = 20e-6,
    t_prefill_token: float = 1.5e-6,
    t_page_fetch: float = 30e-6,
    ttft_slo_steps: float = 75.0,
    tpot_slo_steps: float = 6.0,
    seed: int = 0,
) -> Dict[str, float]:
    """Watermark-FIFO vs SLO-aware scheduling on one production trace.

    Draws ``n_requests`` arrivals from :mod:`repro_torch.serve.workload`
    (bursty diurnal interarrivals, lognormal prompts, Zipf outputs,
    half interactive with TTFT/TPOT SLOs, half batch caring only about
    completion) and rescales arrival times so the offered load is
    exactly ``oversub`` times the *measured* capacity: a calibration
    run with every arrival at t=0 gives the service-limited makespan
    (chunk-slot limits and partial occupancy included), and the
    arrival horizon is that makespan over ``oversub``.  SLOs are
    expressed in decode steps (``ttft_slo_steps``/``tpot_slo_steps``)
    so they track the clock model.  The same trace then runs under
    the engine's two :class:`~repro_torch.serve.policy.SchedulerPolicy`
    flavours, modeled on the chunk-queue virtual clock of
    :func:`simulate_mixed_batching`:

    * **watermark** — FIFO admission whenever a slot is free and the
      pool sits above the low watermark, arrival-order chunk slots, no
      preemption: pure utilisation scheduling, blind to tiers,
    * **slo** — EDF queue ordering with interactive ahead of batch,
      batch admissions shed while free pages sit within
      ``batch_headroom`` of the watermark, and a waiting interactive
      request preempts the maximum-slack running batch request (its
      pages written back BULK; the resume later pays one overlapped
      ``t_page_fetch`` before decoding again, the LATENCY refetch).

    Goodput counts only tokens from requests that met *their own*
    SLOs (batch, unconstrained, always attains on completion), so
    serving a doomed request is wasted work — the metric the SLO
    policy maximises and utilisation scheduling leaves on the table.
    Returns interactive goodput under both policies and their ratio
    (``goodput_ratio > 1`` means tier-aware scheduling won), per-tier
    attainment, interactive TTFT p95s and the preempt/shed counts.
    """
    # imported lazily: repro_torch.serve imports repro_torch.paging, not
    # vice versa
    from repro_torch.serve.workload import WorkloadSpec, generate

    ttft_slo = ttft_slo_steps * t_decode_step
    tpot_slo = tpot_slo_steps * t_decode_step
    trace = generate(n_requests,
                     WorkloadSpec(rate=1000.0, ttft_slo=ttft_slo,
                                  tpot_slo=tpot_slo),
                     seed=seed)
    n = len(trace)
    pages = [-(-(wr.prompt_len + wr.output_len) // page_size)
             for wr in trace]
    pool_pages = (max_batch * pages[int(0.9 * (n - 1))]
                  + low_watermark)
    pool_pages = max(pool_pages, max(pages) + low_watermark)
    interactive = [wr.tier == 0 for wr in trace]   # Tier.INTERACTIVE

    def run(slo_aware: bool, arrival: list,
            span: float = 1.0) -> Dict[str, float]:
        now = 0.0
        free = pool_pages
        nxt = 0                              # next trace index to arrive
        queue: list = []
        running: Dict[int, int] = {}         # idx -> decoded tokens
        prefilling: Dict[int, int] = {}      # idx -> prefilled tokens
        resume_at: Dict[int, float] = {}     # parked resume: pages landing
        held: Dict[int, int] = {}
        t_first = [None] * n
        t_last = [0.0] * n
        parked_progress: Dict[int, int] = {}  # idx -> decoded when parked
        done = 0
        preempts = 0
        sheds = 0

        def deadline(i: int) -> float:
            wr = trace[i]
            if t_first[i] is None:
                return (arrival[i] + wr.ttft_slo
                        if wr.ttft_slo is not None else float("inf"))
            return (t_last[i] + wr.tpot_slo
                    if wr.tpot_slo is not None else float("inf"))

        while done < n:
            while nxt < n and arrival[nxt] <= now:
                queue.append(nxt)
                nxt += 1
            if slo_aware:
                queue.sort(key=lambda i: (int(trace[i].tier), deadline(i),
                                          arrival[i]))
            idle = not running and not prefilling
            shed_here = False
            while queue and (len(running) + len(prefilling)) < max_batch:
                i = queue[0]
                need = pages[i]
                if (slo_aware and not idle
                        and trace[i].tier != 0
                        and free - need < low_watermark + batch_headroom):
                    shed_here = True         # shed batch under pressure
                    break
                if free - need < low_watermark:
                    break
                queue.pop(0)
                free -= need
                held[i] = need
                if i in parked_progress:     # resume: refetch then decode
                    running[i] = parked_progress.pop(i)
                    resume_at[i] = now + t_page_fetch
                else:
                    prefilling[i] = 0
            if shed_here:
                sheds += 1
            # a waiting interactive request evicts the max-slack batch one
            if (slo_aware and queue
                    and (len(running) + len(prefilling)) >= max_batch):
                head = queue[0]
                batch_running = [i for i in running
                                 if not interactive[i]
                                 and resume_at.get(i, 0.0) <= now]
                if (interactive[head] and t_first[head] is None
                        and batch_running):
                    victim = max(batch_running,
                                 key=lambda i: (trace[i].output_len
                                                - running[i], -arrival[i]))
                    parked_progress[victim] = running.pop(victim)
                    free += held.pop(victim)
                    resume_at.pop(victim, None)
                    queue.append(victim)
                    preempts += 1
                    continue                 # re-sort, admit the head
            if not running and not prefilling:
                if not queue and nxt < n:
                    now = max(now, arrival[nxt])   # fast-forward idle gap
                    continue
                if queue:                    # pool-blocked head: wait it out
                    now += t_decode_step
                    continue
                break
            # one fused engine step: decode for every live slot + chunks
            chunk_work = 0
            order = sorted(prefilling, key=(
                (lambda i: (int(trace[i].tier), deadline(i), arrival[i]))
                if slo_aware else (lambda i: arrival[i])))
            for i in order[:chunk_slots]:
                take = min(chunk_tokens, trace[i].prompt_len - prefilling[i])
                prefilling[i] += take
                chunk_work += take
            live = [i for i in running if resume_at.get(i, 0.0) <= now]
            step = max(t_decode_step if live else 0.0,
                       chunk_work * t_prefill_token)
            step = step or t_decode_step
            now += step
            for i in sorted(prefilling):
                if prefilling[i] >= trace[i].prompt_len:
                    del prefilling[i]
                    t_first[i] = now
                    t_last[i] = now
                    running[i] = 1           # first token from prefill
            for i in sorted(running):
                if resume_at.get(i, 0.0) > now:
                    continue                 # parked pages still in flight
                resume_at.pop(i, None)
                running[i] += 1
                t_last[i] = now
                if running[i] >= trace[i].output_len:
                    free += held.pop(i)
                    del running[i]
                    done += 1

        # goodput normalizes by the shared arrival horizon (``span``),
        # not this run's own makespan: both policies face the same
        # offered load over the same window, and the batch drain tail
        # (which shedding deliberately lengthens) should not dilute
        # interactive goodput.
        elapsed = max(now, 1e-30)
        good_tokens = 0
        int_attained = 0
        int_total = 0
        int_ttft = []
        batch_tokens = 0
        for i, wr in enumerate(trace):
            ttft = (t_first[i] - arrival[i]
                    if t_first[i] is not None else float("inf"))
            tpot = ((t_last[i] - t_first[i]) / (wr.output_len - 1)
                    if t_first[i] is not None and wr.output_len > 1 else 0.0)
            ok = ((wr.ttft_slo is None or ttft <= wr.ttft_slo)
                  and (wr.tpot_slo is None or tpot <= wr.tpot_slo))
            if interactive[i]:
                int_total += 1
                int_ttft.append(ttft)
                if ok:
                    int_attained += 1
                    good_tokens += wr.output_len
            else:
                batch_tokens += wr.output_len
        int_ttft.sort()
        return {
            "goodput": good_tokens / max(span, 1e-30),
            "attain": int_attained / max(1, int_total),
            "ttft_p95": int_ttft[min(len(int_ttft) - 1,
                                     int(0.95 * len(int_ttft)))]
            if int_ttft else 0.0,
            "ttft_p99": int_ttft[min(len(int_ttft) - 1,
                                     int(0.99 * len(int_ttft)))]
            if int_ttft else 0.0,
            "batch_tok_per_s": batch_tokens / max(span, 1e-30),
            "wall": elapsed,
            "preempts": preempts,
            "sheds": sheds,
        }

    # self-calibrate capacity: the service-limited makespan with every
    # arrival at t=0 is what max_batch slots can actually do on this
    # trace (chunk-slot limits and partial occupancy included), so the
    # offered load is exactly ``oversub`` x measured capacity.
    makespan = run(slo_aware=False, arrival=[0.0] * n)["wall"]
    horizon = makespan / max(oversub, 1e-9)
    scale = horizon / max(trace[-1].arrival_t, 1e-30)
    arrival = [wr.arrival_t * scale for wr in trace]

    wm = run(slo_aware=False, arrival=arrival, span=horizon)
    slo = run(slo_aware=True, arrival=arrival, span=horizon)
    return {
        "oversub": oversub,
        "pool_pages": pool_pages,
        "n_requests": float(n),
        "int_goodput_wm": wm["goodput"],
        "int_goodput_slo": slo["goodput"],
        "goodput_ratio": slo["goodput"] / max(wm["goodput"], 1e-30),
        "int_attain_wm": wm["attain"],
        "int_attain_slo": slo["attain"],
        "ttft_p95_wm_us": wm["ttft_p95"] * 1e6,
        "ttft_p95_slo_us": slo["ttft_p95"] * 1e6,
        "ttft_p99_wm_us": wm["ttft_p99"] * 1e6,
        "ttft_p99_slo_us": slo["ttft_p99"] * 1e6,
        "batch_tok_per_s_wm": wm["batch_tok_per_s"],
        "batch_tok_per_s_slo": slo["batch_tok_per_s"],
        "preemptions_slo": float(slo["preempts"]),
        "shed_admissions_slo": float(slo["sheds"]),
        "wall_wm": wm["wall"],
        "wall_slo": slo["wall"],
    }
