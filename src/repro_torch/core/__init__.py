"""AMU core — the paper's contribution (async memory unit) as a host runtime.

Layers:
  * :mod:`repro_torch.core.amu`      — request queue, ids, getfin, config registers
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

__all__ = [
    "AMU", "AccessConfig", "AMUError", "QoS", "QueueFullPolicy", "Request",
    "RequestState", "SimBackend", "FAILURE_CODE",
    "FarMemoryTier", "StreamingPrefetcher",
]
