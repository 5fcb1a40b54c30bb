"""Serving driver: the port's continuous-batching engine over synthetic
requests.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --requests 8 --max-new 12 --chunk-tokens 256 --device cuda

Every engine flag is auto-generated from the
:class:`repro_torch.serve.config.EngineConfig` dataclass fields (one flag
per knob, help text included), including ``--device {cuda,cpu}``
(default ``cuda``).  The weights
are random, drawn from ``--seed`` on the device; ``--smoke`` picks the
architecture's reduced config.  ``--speculate-k K`` turns on
self-speculative verify-K decode, and ``--kv-quant {int8,fp8}`` the
quantized page pool (int8 / fp8 frames with per-(frame, KV head)
scales).  Options the port does not serve yet (other roles, prefix
cache) raise ``NotImplementedError`` from the engine.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.models.model import init_params
from repro_torch.serve.config import add_config_args, config_from_args
from repro_torch.serve.engine import Engine


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
    print(f"[serve] page pool {eng.page_pool.n_pages} x "
          f"{eng.page_size} tok, {eng.cache.kv['k_pages'].dtype} frames of "
          f"{eng.pager.page_nbytes} B: preemptions {eng.stats['preemptions']}, "
          f"resumes {eng.stats['resumes']}, pager {dict(eng.pager.stats)}")
    print(f"[serve] chunked prefill: {eng.stats['chunks']} chunks of "
          f"<= {eng.chunk_tokens} tok across "
          f"{eng.stats['mixed_steps']} mixed steps")
    if eng.speculating:
        s = eng.stats
        mean_k = s["accepted"] / max(1, s["spec_steps"])
        rate = s["accepted"] / max(1, s["drafted"])
        print(f"[serve] speculation k={eng.speculate_k}: "
              f"{s['spec_steps']} verify steps, "
              f"{s['drafted']} drafted / {s['accepted']} accepted "
              f"({rate:.0%}), mean accepted-K {mean_k:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12,
                    help="new tokens per request")
    ap.add_argument("--seed", type=int, default=0)
    add_config_args(ap)     # one --flag per EngineConfig field
    args = ap.parse_args(argv)
    econf = config_from_args(args)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(econf.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)

    eng = Engine(cfg, params, econf)
    del params                       # the engine holds its cast copy
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(32, econf.max_len // 2)))
        eng.submit(rng.integers(0, cfg.vocab_size, plen),
                   max_new_tokens=args.max_new)
    out = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    _report(eng, econf, out, wall)
    if econf.obs.trace_out:
        print(f"[serve] trace written to {econf.obs.trace_out}")
    if econf.obs.metrics_out:
        print(f"[serve] metrics written to {econf.obs.metrics_out}")
    return out


if __name__ == "__main__":
    main()
