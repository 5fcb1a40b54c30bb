"""Serving driver: the port's continuous-batching engine over synthetic
requests.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --requests 8 --max-new 12 --chunk-tokens 256 --device cuda

``--arch`` takes every registered architecture
(:data:`repro_torch.configs.ARCH_IDS`: rwkv6-7b, seamless-m4t-medium,
qwen2-vl-72b, mistral-nemo-12b, command-r-plus-104b, h2o-danube-1.8b,
phi4-mini-3.8b, olmoe-1b-7b, llama4-maverick-400b-a17b, zamba2-1.2b;
rwkv6-7b, which has no attention KV, is served without a page pool, and
seamless-m4t-medium's requests carry random source frame embeddings).
Every engine flag is auto-generated from the
:class:`repro_torch.serve.config.EngineConfig` dataclass fields (one flag
per knob, help text included), including ``--device {cuda,cpu}``
(default ``cuda``) and ``--role`` (fused / prefill / decode).  The
weights are random, drawn from ``--seed`` on the device; ``--smoke``
picks the architecture's reduced config.  ``--speculate-k K`` turns on
self-speculative verify-K decode, ``--kv-quant {int8,fp8}`` the
quantized page pool (int8 / fp8 frames with per-(frame, KV head)
scales), ``--prefix-cache`` cross-request prefix sharing,
``--offload-finished`` the finished-sequence far-tier store,
``--chunk-tokens 0`` the whole-prompt dense prefill at admission (padded
to ``--prefill-buckets N,N,...``; prompts longer than an SWA slot take
it anyway).  Script extras:

  * ``--shared-prefix N`` prepends the same N tokens to every prompt
    (system-prompt traffic, which makes ``--prefix-cache`` visible),
  * ``--disagg`` runs a PREFILL and a DECODE engine over ONE shared far
    tier in this process, driven by
    :func:`repro_torch.serve.disagg.run_disaggregated`,
  * ``--role prefill --handoff-spool d.pkl`` runs the prefill half
    alone and spools its records *plus their tier entries* to a file;
    ``--role decode --handoff-spool d.pkl`` adopts that spool in a
    separate process (the two-process version of ``--disagg``; both
    draw the same weights from ``--seed``),
  * ``--workload`` replaces the uniform synthetic requests with the
    production traffic model (:mod:`repro_torch.serve.workload`): bursty
    diurnal arrivals at ``--workload-rate`` a virtual second, lognormal
    prompts, Zipf outputs, and an interactive/batch tier split with
    per-request TTFT/TPOT SLOs, replayed on the engine's clock,
  * ``--slo`` is shorthand for ``--policy slo`` (goodput scheduling: EDF
    chunk order, batch shedding, deadline-aware preemption); with
    ``--workload`` or ``--slo`` the run ends with the per-tier
    attainment report (:meth:`~repro_torch.serve.engine.Engine.
    slo_report`),
  * ``--dense`` turns paging off (``paging.enabled=False``): the dense
    per-slot cache, the A/B reference of the paged decode path.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --workload --slo
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models.model import init_params
from repro_torch.serve.config import (EngineConfig, add_config_args,
                                      config_from_args)
from repro_torch.serve.disagg import (make_shared_tier, run_disaggregated,
                                      spool_load, spool_save,
                                      tier_pager_factory)
from repro_torch.serve.engine import Engine
from repro_torch.serve.workload import WorkloadSpec, generate

__all__ = ["build_parser", "engine_config", "submit_requests",
           "print_slo_report", "main"]


def submit_requests(eng, args, cfg, econf, rng) -> None:
    """Queue the synthetic or workload-model requests on ``eng``: each
    prompt is ``--shared-prefix`` tokens, then a unique tail — 4 to 31
    tokens, or with ``--workload`` the trace's prompt length (cut so
    that the prompt and its outputs fit ``max_len``), submitted with the
    trace's output length, tier, SLOs and arrival time.  An enc-dec
    request's source is a standard normal draw of frame embeddings, as
    many as the whole prompt with ``--workload`` and as the unique tail
    without, as the reference draws them."""
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix)
    encdec = cfg.family == "encdec"

    def source(n):
        return ({"src_embeds": rng.standard_normal(
            (n, cfg.d_model)).astype(np.float32)} if encdec else {})
    if args.workload:
        spec = WorkloadSpec(rate=args.workload_rate,
                            max_prompt=max(4, econf.max_len // 2))
        for wr in generate(args.requests, spec, seed=args.seed):
            plen = min(wr.prompt_len, econf.max_len - wr.output_len - 1)
            prompt = np.concatenate(
                [shared, rng.integers(0, cfg.vocab_size, max(1, plen))])
            eng.submit(prompt, max_new_tokens=wr.output_len,
                       tier=wr.tier, ttft_slo=wr.ttft_slo,
                       tpot_slo=wr.tpot_slo, arrival_t=wr.arrival_t,
                       **source(len(prompt)))
        return
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(32, econf.max_len // 2)))
        prompt = np.concatenate(
            [shared, rng.integers(0, cfg.vocab_size, plen)])
        eng.submit(prompt, max_new_tokens=args.max_new, **source(plen))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _report(eng, econf, out, wall) -> None:
    total_new = sum(len(v) for v in out.values())
    lat = [r.done_t - r.submitted_t for r in eng.finished.values()]
    ttft = [r.first_token_t - r.submitted_t for r in eng.finished.values()]
    print(f"[serve] {len(out)} requests, {total_new} tokens in {wall:.2f}s "
          f"({total_new / wall:.1f} tok/s) on {eng.device}")
    print(f"[serve] decode steps {eng.stats['steps']} "
          f"(batch occupancy "
          f"{total_new / max(1, eng.stats['steps'] * econf.max_batch):.2f})")
    if lat:
        print(f"[serve] mean TTFT {np.mean(ttft)*1e3:.0f} ms, "
              f"mean latency {np.mean(lat)*1e3:.0f} ms (virtual clock)")
    if eng.paging:
        print(f"[serve] page pool {eng.page_pool.n_pages} x "
              f"{eng.page_size} tok, {eng.cache.kv['k_pages'].dtype} frames "
              f"of {eng.pager.page_nbytes} B: preemptions "
              f"{eng.stats['preemptions']}, resumes {eng.stats['resumes']}, "
              f"pager {dict(eng.pager.stats)}")
    elif "k" in eng.cache.kv:
        print(f"[serve] dense per-slot cache, "
              f"{eng.cache.kv['k'].dtype} K/V of "
              f"{tuple(eng.cache.kv['k'].shape)}")
    if eng.cache.ssm:
        state = sum(t.numel() * t.element_size() for t in eng.cache.ssm)
        print(f"[serve] recurrent state: {state // econf.max_batch} B a "
              f"slot ({', '.join(str(tuple(t.shape)) for t in eng.cache.ssm)})")
    cross = getattr(eng.cache, "cross", {})
    if cross:
        nbytes = sum(t.numel() * t.element_size() for t in cross.values())
        print(f"[serve] cross state (encoder K/V and output): "
              f"{nbytes // econf.max_batch} B a slot "
              f"({', '.join(str(tuple(t.shape)) for t in cross.values())})")
    print(f"[serve] chunked prefill: {eng.stats['chunks']} chunks of "
          f"<= {eng.chunk_tokens} tok across "
          f"{eng.stats['mixed_steps']} mixed steps; dense prefills "
          f"{eng.stats['prefills']} (buckets {eng.buckets})")
    if eng.speculating:
        s = eng.stats
        mean_k = s["accepted"] / max(1, s["spec_steps"])
        rate = s["accepted"] / max(1, s["drafted"])
        print(f"[serve] speculation k={eng.speculate_k}: "
              f"{s['spec_steps']} verify steps, "
              f"{s['drafted']} drafted / {s['accepted']} accepted "
              f"({rate:.0%}), mean accepted-K {mean_k:.2f}")
    if eng.prefix is not None:
        print(f"[serve] prefix cache: {eng.stats['prefix_hits']} page hits "
              f"({eng.stats['prefix_far_hits']} far), "
              f"{eng.stats['prefix_tokens_saved']} prefill tokens saved, "
              f"{eng.prefix.stats['interned']} pages interned")


def print_slo_report(eng, econf) -> dict:
    """Print the per-tier SLO lines of ``eng.slo_report()`` (on the
    engine's clock) and the scheduler's shed and miss counts; returns
    the report."""
    rep = eng.slo_report()
    for tier in ("interactive", "batch"):
        tr = rep[tier]
        print(f"[serve] {tier}: {tr['n']} reqs, "
              f"attainment {tr['attainment']:.2f}, "
              f"goodput {tr['goodput']:.1f} tok/s (engine clock), "
              f"ttft p95 {tr['ttft_p95']*1e3:.1f} ms")
    print(f"[serve] scheduler: policy={econf.scheduler.policy} "
          f"shed={eng.stats['shed_admissions']} "
          f"deadline_misses={eng.stats['deadline_misses']}")
    return rep


def _role_config(econf, role: str, factory, board=None):
    """The fused CLI config re-targeted at one disaggregated role."""
    return dataclasses.replace(
        econf, role=role, handoff=board,
        paging=dataclasses.replace(econf.paging, pager_factory=factory))


def _run_disagg(args, econf, cfg, params, rng):
    """In-process PREFILL + DECODE walkthrough over one shared tier; both
    engines hold the same weight tensors."""
    tier = make_shared_tier()
    factory = tier_pager_factory(tier)
    pre = Engine(cfg, params, _role_config(econf, "prefill", factory))
    dec = Engine(cfg, pre.params, _role_config(econf, "decode", factory,
                                               board=pre.handoff))
    submit_requests(pre, args, cfg, econf, rng)
    t0 = time.time()
    out = run_disaggregated(pre, dec)
    _sync(dec.device)
    wall = time.time() - t0
    total_new = sum(len(v) for v in out.values())
    print(f"[serve] disaggregated: {len(out)} requests, {total_new} "
          f"tokens in {wall:.2f}s ({total_new / wall:.1f} tok/s) on "
          f"{dec.device}")
    print(f"[serve] prefill: {pre.stats['handoffs']} handoffs, "
          f"{pre.stats['chunks']} chunks, "
          f"pager {dict(pre.pager.stats)}")
    print(f"[serve] decode:  {dec.stats['handoffs']} adoptions, "
          f"{dec.stats['resumes']} resumes, "
          f"{dec.stats['steps']} steps, pager {dict(dec.pager.stats)}")
    print(f"[serve] shared tier: {dict(tier.stats)}")
    return out


def _run_role(args, econf, cfg, params, rng):
    """One disaggregated half in this process, handing off via a spool
    file (``--role prefill`` writes it, ``--role decode`` adopts it)."""
    if not args.handoff_spool:
        raise SystemExit(
            "--role prefill/decode needs --handoff-spool PATH (or use "
            "--disagg to run both halves in one process)")
    tier = make_shared_tier()
    factory = tier_pager_factory(tier)
    eng = Engine(cfg, params, _role_config(econf, econf.role, factory))
    t0 = time.time()
    if econf.role == "prefill":
        submit_requests(eng, args, cfg, econf, rng)
        eng.run()
        recs = eng.handoff.poll()
        spool_save(args.handoff_spool, recs, tier)
        wall = time.time() - t0
        print(f"[serve] prefill: {len(recs)} handoff records "
              f"(+ tier entries) spooled to {args.handoff_spool} "
              f"in {wall:.2f}s")
        print(f"[serve] prefill pager {dict(eng.pager.stats)}")
        return {rec.rid: list(rec.generated) for rec in recs}
    recs = spool_load(args.handoff_spool, tier)
    for rec in recs:
        eng.admit_handoff(rec)
    out = eng.run()
    _sync(eng.device)
    wall = time.time() - t0
    print(f"[serve] decode: adopted {len(recs)} records from "
          f"{args.handoff_spool}")
    _report(eng, econf, out, wall)
    return out


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the script extras and one flag per
    :class:`~repro_torch.serve.config.EngineConfig` field."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12,
                    help="new tokens per request (uniform mode)")
    ap.add_argument("--dense", action="store_true",
                    help="force the dense per-slot KV cache (A/B "
                         "reference for the paged decode path)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical prefix tokens to "
                         "every synthetic prompt (system-prompt traffic "
                         "model, makes --prefix-cache visible)")
    ap.add_argument("--workload", action="store_true",
                    help="draw requests from the production traffic "
                         "model (bursty/diurnal arrivals, heavy-tailed "
                         "lengths, interactive/batch tiers with SLOs)")
    ap.add_argument("--workload-rate", type=float, default=200.0,
                    help="mean arrival rate for --workload "
                         "(requests per virtual second)")
    ap.add_argument("--slo", action="store_true",
                    help="shorthand for --policy slo (goodput "
                         "scheduling; pairs with --workload)")
    ap.add_argument("--disagg", action="store_true",
                    help="run a PREFILL and a DECODE engine over one "
                         "shared far tier in this process (see "
                         "--role/--handoff-spool for the two-process "
                         "version)")
    ap.add_argument("--handoff-spool", default=None, metavar="PATH",
                    help="with --role prefill: write handoff records + "
                         "tier entries here after the run; with --role "
                         "decode: adopt them from here")
    ap.add_argument("--seed", type=int, default=0)
    add_config_args(ap)     # one --flag per EngineConfig field
    return ap


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The :class:`EngineConfig` of parsed flags, with ``--dense`` and
    ``--slo`` applied."""
    overrides = {}
    if args.dense:
        overrides["paging_enabled"] = False
    if args.slo:
        overrides["scheduler_policy"] = "slo"
    return config_from_args(args, **overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    econf = engine_config(args)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(econf.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)

    if args.disagg:
        return _run_disagg(args, econf, cfg, params, rng)
    if econf.role != "fused":
        return _run_role(args, econf, cfg, params, rng)

    eng = Engine(cfg, params, econf)
    del params                       # the engine holds its cast copy
    t0 = time.time()
    submit_requests(eng, args, cfg, econf, rng)
    out = eng.run()
    _sync(device)
    wall = time.time() - t0
    _report(eng, econf, out, wall)
    if eng.offload_finished:
        print(f"[serve] far-tier AMU stats: {dict(eng.far_tier.amu.stats)}")
    if args.workload or args.slo:
        print_slo_report(eng, econf)
    if econf.obs.trace_out:
        print(f"[serve] trace written to {econf.obs.trace_out}")
    if econf.obs.metrics_out:
        print(f"[serve] metrics written to {econf.obs.metrics_out}")
    return out


if __name__ == "__main__":
    main()
