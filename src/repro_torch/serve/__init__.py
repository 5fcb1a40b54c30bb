"""repro_torch.serve — continuous-batching inference over the paged KV pool.

The engine of the JAX package's ``repro.serve`` (paged, chunked), in
its FUSED role and as the PREFILL / DECODE halves of a disaggregated
pair, assembled the same way from role components:

  * :mod:`repro_torch.serve.config` — the frozen
    :class:`~repro_torch.serve.config.EngineConfig` construction API, the
    :class:`~repro_torch.serve.config.Tier` priority enum and the
    injected :class:`~repro_torch.serve.config.VirtualClock`,
  * :mod:`repro_torch.serve.request` — the request lifecycle record,
  * :mod:`repro_torch.serve.policy` — the watermark and SLO schedulers,
  * :mod:`repro_torch.serve.admission` — chunk-queue admission, prefix
    mapping and the DECODE role's ``admit_handoff``,
  * :mod:`repro_torch.serve.transfer` — park/resume, pool plumbing, the
    copy-on-write guard, finished-sequence offload/fetch and the
    PREFILL role's handoff publish,
  * :mod:`repro_torch.serve.decode` — the step loop and finish path,
  * :mod:`repro_torch.serve.engine` — the assembly,
  * :mod:`repro_torch.serve.disagg` — disaggregated prefill/decode: the
    :class:`~repro_torch.serve.disagg.HandoffRecord` /
    :class:`~repro_torch.serve.disagg.HandoffBoard` handoff protocol,
    the shared-tier pager factory and the
    :func:`~repro_torch.serve.disagg.run_disaggregated` loop,
  * :mod:`repro_torch.serve.workload` — the production traffic model
    (bursty diurnal arrivals, lognormal/Zipf lengths, interactive-vs-batch
    tiers with per-request TTFT/TPOT SLOs),
  * :mod:`repro_torch.serve.kv_cache` — the slot pool, the aux residue
    and page split/join for far-tier payloads.

Minimal use::

    from repro_torch.serve import Engine, EngineConfig, ChunkingConfig
    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_len=256,
        chunking=ChunkingConfig(chunk_tokens=32)))
    rid = eng.submit(prompt_tokens, max_new_tokens=16)
    tokens = eng.run()[rid]
"""

from repro_torch.serve.config import (ChunkingConfig, EngineConfig,
                                      EngineRole, PagingConfig,
                                      SchedulerConfig, SpeculationConfig,
                                      Tier, VirtualClock)
from repro_torch.serve.disagg import (HandoffBoard, HandoffRecord,
                                      make_shared_tier, run_disaggregated,
                                      tier_pager_factory)
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.policy import SchedulerPolicy, SLOScheduler
from repro_torch.serve.workload import WorkloadRequest, WorkloadSpec, generate

__all__ = [
    "Engine", "Request", "SchedulerPolicy", "SLOScheduler", "EngineConfig",
    "PagingConfig", "ChunkingConfig", "SchedulerConfig", "SpeculationConfig",
    "Tier", "VirtualClock", "EngineRole", "HandoffBoard", "HandoffRecord",
    "make_shared_tier", "tier_pager_factory", "run_disaggregated",
    "WorkloadRequest", "WorkloadSpec", "generate",
]
