"""The request lifecycle record shared by every engine role component.

A :class:`Request` moves through admit → (chunked prefill) → decode →
park/resume (any number of times, from either phase) → finish.  Under
the disaggregated topology the same record crosses an engine boundary:
a PREFILL-role engine finishes it at its first token and publishes a
:class:`~repro.serve.disagg.HandoffRecord`; a DECODE-role engine
rebuilds it (parked, with its aux residue) and decodes it to
completion through the ordinary resume machinery.  The fields are the
complete per-request state either side needs — nothing request-scoped
lives anywhere else.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from repro_torch.serve.config import Tier

__all__ = ["Request"]


@dataclass
class Request:
    """One submitted generation request and its full lifecycle state.

    A request moves through admit → (chunked prefill) → decode →
    park/resume (any number of times, from either phase) → finish; see
    ``docs/ARCHITECTURE.md`` for the lifecycle diagram.  Example::

        rid = engine.submit(np.arange(7), max_new_tokens=4)
        tokens = engine.run()[rid]
    """

    rid: int
    prompt: np.ndarray                  # (plen,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # SLO contract (production traffic model; see repro.serve.workload):
    tier: Tier = Tier.INTERACTIVE
    ttft_slo: Optional[float] = None    # time-to-first-token budget
    tpot_slo: Optional[float] = None    # mean time-per-output-token budget
    arrival_t: float = 0.0              # when the request enters the system
    # filled by the engine:
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    submitted_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0
    token_ts: List[float] = field(default_factory=list)  # one per token
    # paging state (set when the request has been preempted):
    parked: bool = False                # preempted, waiting to resume
    residue: Any = None                 # non-KV aux payload while parked
    n_preempts: int = 0
    admit_seq: int = -1                 # admission order (preemption priority)
    # chunked-prefill state (chunk-queue admission path):
    prefill_pos: int = 0                # prompt tokens already prefilled
    target_len: int = 0                 # tokens the chunk path must cover
    chunk_rows: Any = None              # host page-table row while prefilling
    chunk_ssm: Any = None               # hybrid: SSM carry between chunks

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_id is not None
                    and self.generated[-1] == self.eos_id)

    @property
    def mid_prefill(self) -> bool:
        """True while the prompt is only partially chunk-prefilled."""
        return self.target_len > 0 and self.prefill_pos < self.target_len

    # -- SLO telemetry (all timestamps on the engine's one clock) ----------
    @property
    def ttft(self) -> float:
        """Time to first token (inf until one exists)."""
        if not self.token_ts:
            return float("inf")
        return self.token_ts[0] - self.arrival_t

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (0 for 1 token)."""
        if len(self.token_ts) < 2:
            return 0.0
        return ((self.token_ts[-1] - self.token_ts[0])
                / (len(self.token_ts) - 1))

    def slo_attained(self) -> bool:
        """Did this request meet every SLO it carries?  A request with
        no SLOs trivially attains (batch completion traffic)."""
        if self.ttft_slo is not None and self.ttft > self.ttft_slo:
            return False
        if self.tpot_slo is not None and self.tpot > self.tpot_slo:
            return False
        return True
