"""Serving example: continuous batching with the event-driven scheduler
over an *oversubscribed* device page pool.

Submits a burst of mixed-length requests against a small dense model
(the ``mistral-nemo-12b`` SMOKE config, random weights from seed 0) and
shows the engine admitting new requests into slots the moment others
finish (no drain barrier), KV paged over a device pool smaller than the
aggregate demand — cold pages park in the far tier via BULK astore and
come back hot-tail-first via LATENCY aload — with finished sequences'
KV parked page by page in the same host far tier through the AMU.  The
port of the JAX package's ``examples/serve_engine.py``, with its
settings and its printed lines.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_engine [--device cpu]

The device defaults to ``cuda``, where attention runs the hand-written
paged kernels; ``--device cpu`` runs their plain versions.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.model import init_params
from repro_torch.serve import (ChunkingConfig, Engine, EngineConfig,
                               PagingConfig)

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Serve the example's 10 requests; prints its lines and returns the
    engine's counts (requests, tokens, steps, chunks, mixed steps, dense
    prefills, preemptions, resumes)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the engine's tensors (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = get_smoke("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    # 4 slots x 12 pages would want 48 device pages; give it 12 so the
    # engine must oversubscribe: preempt cold pages, prefetch on resume.
    # chunk_tokens=8: admission is the chunk queue — prompts prefill in
    # 8-token chunks fused with running decodes (no admission bubble).
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_len=96, prefill_buckets=(16, 32, 64),
        device=args.device,
        paging=PagingConfig(page_size=8, device_pages=12,
                            offload_finished=True),
        chunking=ChunkingConfig(chunk_tokens=8)))

    rng = np.random.default_rng(7)
    n_requests = 10
    for _ in range(n_requests):
        plen = int(rng.integers(4, 24))
        new = int(rng.integers(4, 12))
        eng.submit(rng.integers(0, cfg.vocab_size, plen), max_new_tokens=new)
    out = eng.run()

    total = sum(len(v) for v in out.values())
    occ = total / max(1, eng.stats["steps"] * eng.max_batch)
    print(f"[serve] {len(out)} requests -> {total} tokens in "
          f"{eng.stats['steps']} decode steps "
          f"(occupancy {occ:.2f}; 4 slots, mixed depths)")
    print(f"[serve] chunked prefill: {eng.stats['chunks']} chunks over "
          f"{eng.stats['mixed_steps']} mixed steps "
          f"({eng.stats['prefills']} dense fallbacks)")
    print(f"[serve] page pool: {eng.page_pool.n_pages} pages x "
          f"{eng.page_size} tok, preemptions {eng.stats['preemptions']}, "
          f"resumes {eng.stats['resumes']}")
    print(f"[serve] pager ops: {dict(eng.pager.stats)}")
    print(f"[serve] far-tier AMU ops: {dict(eng.far_tier.amu.stats)}")
    for rid in sorted(out)[:3]:
        print(f"  request {rid}: {out[rid]}")
    if len(out) != n_requests:
        raise RuntimeError(f"{len(out)} of {n_requests} requests finished")
    return {"requests": len(out), "tokens": total,
            **{k: int(eng.stats[k]) for k in (
                "steps", "chunks", "mixed_steps", "prefills",
                "preemptions", "resumes")}}


if __name__ == "__main__":
    main()
