"""Far-memory parameter streaming — the paper's scenario end-to-end.

A model whose weights do NOT fit in the near tier (think llama4-maverick
400B against one card's HBM) keeps layer weights in far memory and
streams them through the AMU with ``prefetch_depth`` layers in flight,
while the compute consumes the current layer — the paper's stream
pattern plus its bandwidth-aggregation argument, measurable here via
the simulated clock:

  blocking  : t_total ~= L * (t_fetch + t_compute)
  AMU depth2: t_total ~= t_fetch + L * max(t_fetch, t_compute)

The port of the JAX package's ``examples/far_memory_stream.py``, with
its constants, its virtual-clock arithmetic and its printed lines; the
layer blocks are tensors on the chosen device.

Run:  PYTHONPATH=src python -m repro_torch.launch.far_memory_stream
          [--device cpu]

The device defaults to ``cuda``; ``--device cpu`` keeps the blocks in
host memory.  The times are the simulated clock's, so they are the same
on either device.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import (AMU, AccessConfig, FarMemoryTier, QoS,
                              SimBackend, StreamingPrefetcher)

__all__ = ["run", "main"]

L = 16                        # layers
BYTES_PER_LAYER = 64 << 20    # 64 MiB per layer block
FAR_BW = 6.4e9                # host->device link (PCIe-ish)
FAR_LAT = 5e-6                # far-memory latency (paper's upper band)
T_COMPUTE = 8e-3              # per-layer compute time
DEPTHS = (1, 2, 4)


def run(depth: int, device="cuda") -> float:
    """Stream the ``L`` layer blocks with ``depth`` fetches in flight (0:
    blocking fetch, then compute); returns the virtual seconds taken."""
    backend = SimBackend(base_latency=FAR_LAT, bandwidth=FAR_BW)
    amu = AMU(backend=backend, max_outstanding=max(2, depth + 1),
              default_config=AccessConfig(granularity_bytes=4 << 20,
                                          qos=QoS.BULK))
    tier = FarMemoryTier(amu)
    for i in range(L):
        tier.offload(i, torch.zeros(BYTES_PER_LAYER // 4,
                                    dtype=torch.float32, device=device),
                     async_=False)
    backend.now = 0.0

    if depth == 0:            # blocking load/store: fetch, then compute
        for i in range(L):
            tier.prefetch(i)
            tier.get(i)                      # blocks until landed
            backend.advance(T_COMPUTE)       # compute with link idle
            tier.evict(i)
        return backend.now

    pf = StreamingPrefetcher(tier, list(range(L)), depth=depth)
    pf.start()
    for i in range(L):
        pf.step()                            # waits only if not landed yet
        backend.advance(T_COMPUTE)           # compute overlaps next fetch
        tier.evict(i)
    return backend.now


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, float]:
    """Print the example's lines; returns the virtual seconds by depth
    (0 = blocking, then each of ``DEPTHS``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the layer blocks (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu)")
    t_fetch = BYTES_PER_LAYER / FAR_BW
    print(f"[stream] {L} layers x {BYTES_PER_LAYER >> 20} MiB, "
          f"t_fetch={t_fetch*1e3:.1f} ms, t_compute={T_COMPUTE*1e3:.1f} ms")
    times = {0: run(0, device)}
    t_block = times[0]
    for depth in DEPTHS:
        t = times[depth] = run(depth, device)
        print(f"[stream] depth={depth}: {t*1e3:7.1f} ms  "
              f"(blocking {t_block*1e3:7.1f} ms, "
              f"speedup {t_block/t:4.2f}x)")
    t2 = run(2, device)
    # with >=2 requests in flight the (multi-channel) far link overlaps
    # fetches too, so the floor is compute-bound: first fetch + L computes
    floor = t_fetch + L * T_COMPUTE
    print(f"[stream] depth=2 vs compute-bound floor {floor*1e3:.1f} ms: "
          f"{t2/floor:.2f}x (1.00 = perfect overlap)")
    if not t2 < t_block * 0.65:
        raise RuntimeError("AMU streaming must beat blocking by >1.5x")
    return times


if __name__ == "__main__":
    main()
