"""Production traffic model for the serving engine (a copy of
the JAX package's ``repro.serve.workload``: the same numpy draws, so the
same ``(n, spec, seed)`` gives the same trace field for field).

Serving papers (and the AMU follow-up's massive-parallelism argument)
agree on the shape of real inference traffic, and none of it looks like
the uniform back-to-back submissions our tests generate:

  * **bursty arrivals** — requests cluster; a Poisson process is too
    smooth.  We draw interarrival gaps from a Gamma distribution with
    shape < 1 (coefficient of variation > 1), the standard burstiness
    knob: the same mean rate arrives as quiet stretches punctuated by
    pile-ups that stress admission and the pager's balance loop.
  * **diurnal modulation** — the mean rate itself swings sinusoidally
    over a "day", so a sweep crosses under- and over-provisioned
    regimes in one trace.
  * **heavy-tailed lengths** — prompt lengths are lognormal (most
    prompts short, a fat tail of huge ones), output lengths Zipf-like
    (many 1–10 token answers, occasional essays).  Tails are what make
    fixed-slot scheduling hard: one essay pins pages for thousands of
    ticks.
  * **priority tiers** — interactive (chat) traffic with tight
    TTFT/TPOT SLOs mixed with batch (summarisation, eval) traffic that
    only cares about completion.  The scheduler maps the tier onto the
    pager's QoS windows.

:func:`generate` returns a list of :class:`WorkloadRequest` sorted by
arrival time, deterministically from a seed — the same trace feeds the
engine (``python -m repro_torch.launch.serve --workload``) and the
:func:`repro_torch.paging.sim.simulate_slo_schedule` virtual-clock
model, so their numbers are comparable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.serve.config import Tier

__all__ = ["WorkloadRequest", "WorkloadSpec", "generate"]


@dataclass(frozen=True)
class WorkloadRequest:
    """One arrival in the trace (everything the engine's ``submit``
    needs, plus the ground-truth SLOs attainment is judged against)."""

    rid: int
    arrival_t: float            # virtual seconds from trace start
    prompt_len: int
    output_len: int
    tier: Tier
    ttft_slo: Optional[float]   # None: unconstrained (batch completion)
    tpot_slo: Optional[float]


@dataclass(frozen=True)
class WorkloadSpec:
    """Knobs of the traffic model (defaults give a chat-heavy mix).

    ``rate`` is the *mean* arrival rate (req per virtual second);
    ``burstiness`` > 1 raises the interarrival coefficient of
    variation (Gamma shape = 1/burstiness²); ``diurnal_amp`` in [0, 1)
    scales the sinusoidal swing of the rate over ``diurnal_period``.
    Prompt lengths are lognormal(``prompt_median``, ``prompt_sigma``)
    clipped to [1, ``max_prompt``]; output lengths are Zipf(``zipf_a``)
    shifted to a minimum of ``min_output`` and clipped to
    ``max_output``.  ``interactive_frac`` of requests are INTERACTIVE
    with (``ttft_slo``, ``tpot_slo``); the rest are BATCH with the
    (looser, possibly None) ``batch_ttft_slo``/``batch_tpot_slo``.
    """

    rate: float = 200.0
    burstiness: float = 2.0
    diurnal_amp: float = 0.5
    diurnal_period: float = 2.0
    prompt_median: float = 24.0
    prompt_sigma: float = 0.7
    max_prompt: int = 192
    zipf_a: float = 1.8
    min_output: int = 2
    max_output: int = 48
    interactive_frac: float = 0.5
    ttft_slo: float = 0.020
    tpot_slo: float = 0.004
    batch_ttft_slo: Optional[float] = None
    batch_tpot_slo: Optional[float] = None


def generate(n: int, spec: WorkloadSpec = WorkloadSpec(),
             seed: int = 0) -> List[WorkloadRequest]:
    """Draw ``n`` arrivals from the traffic model (sorted by time).

    Example::

        trace = generate(64, WorkloadSpec(rate=500.0), seed=1)
        for wr in trace:
            eng.submit(np.arange(wr.prompt_len),
                       max_new_tokens=wr.output_len, tier=wr.tier,
                       ttft_slo=wr.ttft_slo, tpot_slo=wr.tpot_slo,
                       arrival_t=wr.arrival_t)
    """
    if n <= 0:
        return []
    rng = np.random.default_rng(seed)

    # bursty interarrivals: Gamma with mean 1/rate, CV = burstiness
    cv2 = max(1e-6, float(spec.burstiness)) ** 2
    shape = 1.0 / cv2
    gaps = rng.gamma(shape, cv2 / spec.rate, size=n)
    t = np.cumsum(gaps)

    # diurnal modulation by time-warping: where the sinusoidal rate is
    # high, time compresses (arrivals bunch); where low, it stretches.
    if spec.diurnal_amp:
        a = min(0.95, max(0.0, float(spec.diurnal_amp)))
        w = 2 * np.pi / spec.diurnal_period
        # inverse of the integrated rate  Λ(t) = t - (a/w) cos-term
        t = t - (a / w) * np.sin(w * t)

    plen = np.exp(rng.normal(np.log(spec.prompt_median),
                             spec.prompt_sigma, size=n))
    plen = np.clip(plen.round().astype(int), 1, spec.max_prompt)

    out = spec.min_output - 1 + rng.zipf(spec.zipf_a, size=n)
    out = np.clip(out, spec.min_output, spec.max_output)

    inter = rng.random(n) < spec.interactive_frac

    reqs = []
    for i in range(n):
        if inter[i]:
            tier, ttft, tpot = Tier.INTERACTIVE, spec.ttft_slo, spec.tpot_slo
        else:
            tier, ttft, tpot = (Tier.BATCH, spec.batch_ttft_slo,
                                spec.batch_tpot_slo)
        reqs.append(WorkloadRequest(
            rid=i, arrival_t=float(t[i]), prompt_len=int(plen[i]),
            output_len=int(out[i]), tier=tier,
            ttft_slo=ttft, tpot_slo=tpot))
    reqs.sort(key=lambda r: r.arrival_t)
    return reqs
