"""repro_torch.serve — continuous-batching inference over the paged KV pool.

The FUSED-role engine of the JAX package's ``repro.serve``, assembled the
same way from role components:

  * :mod:`repro_torch.serve.config` — the frozen
    :class:`~repro_torch.serve.config.EngineConfig` construction API, the
    :class:`~repro_torch.serve.config.Tier` priority enum and the
    injected :class:`~repro_torch.serve.config.VirtualClock`,
  * :mod:`repro_torch.serve.request` — the request lifecycle record,
  * :mod:`repro_torch.serve.policy` — the watermark and SLO schedulers,
  * :mod:`repro_torch.serve.admission` — chunk-queue admission,
  * :mod:`repro_torch.serve.transfer` — park/resume and pool plumbing,
  * :mod:`repro_torch.serve.decode` — the step loop and finish path,
  * :mod:`repro_torch.serve.engine` — the assembly.

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
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.policy import SchedulerPolicy, SLOScheduler

__all__ = [
    "Engine", "Request", "SchedulerPolicy", "SLOScheduler", "EngineConfig",
    "PagingConfig", "ChunkingConfig", "SchedulerConfig", "SpeculationConfig",
    "Tier", "VirtualClock", "EngineRole",
]
