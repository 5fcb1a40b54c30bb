"""AMU core — the paper's contribution (async memory unit) as a host runtime.

Layers:
  * :mod:`repro_torch.core.amu`      — request queue, ids, getfin, config registers
  * :mod:`repro_torch.core.patterns` — access-pattern registers (stream)
  * :mod:`repro_torch.core.spm`      — SPM budget planner / cache-SPM split
  * :mod:`repro_torch.core.offload`  — far-memory tier + streaming prefetcher
"""

from repro_torch.core.amu import (
    AMU,
    AccessConfig,
    AMUError,
    QoS,
    QueueFullPolicy,
    Request,
    RequestState,
    SimBackend,
    FAILURE_CODE,
)
from repro_torch.core.offload import FarMemoryTier, StreamingPrefetcher
from repro_torch.core.patterns import AccessPattern, StreamPattern, granules
from repro_torch.core.spm import SPMPlan, plan_attention_blocks, plan_matmul_blocks

__all__ = [
    "AMU", "AccessConfig", "AMUError", "QoS", "QueueFullPolicy", "Request",
    "RequestState", "SimBackend", "FAILURE_CODE",
    "FarMemoryTier", "StreamingPrefetcher",
    "AccessPattern", "StreamPattern", "granules",
    "SPMPlan", "plan_attention_blocks", "plan_matmul_blocks",
]
