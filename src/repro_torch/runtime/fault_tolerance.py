"""Fault tolerance & elasticity: watchdog, retry, stragglers, rescale.

Everything here is topology-agnostic logic that a 1000-node deployment
would drive from its coordinator; in a single process it is exercised by
tests with simulated failures.  Standard library only: a copy of the
JAX package's module, which never imports JAX.

Components:
  * :class:`Heartbeat`       — per-step liveness; watchdog flags stalls,
  * :class:`StragglerDetector` — per-step timing outliers + mitigation
    decision (the AMU analogy holds: a straggling *node* is a
    long-latency request; the cure is the same — keep enough outstanding
    work that one slow element doesn't stall the pipeline),
  * :func:`run_with_retries` — step wrapper: on failure, restore the
    latest checkpoint and continue (bounded retries),
  * :func:`elastic_plan`     — after losing nodes, choose the best new
    (data, model) mesh from the survivors and describe the reshard.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Heartbeat", "StragglerDetector", "run_with_retries",
           "elastic_plan", "ElasticPlan", "StepFailure"]


class StepFailure(RuntimeError):
    """Raised by a training step that should trigger recovery."""


class Heartbeat:
    """Liveness tracking: ``beat()`` each step; ``stalled()`` if silent."""

    def __init__(self, timeout_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_beat = clock()
        self.beats = 0

    def beat(self) -> None:
        self.last_beat = self.clock()
        self.beats += 1

    def stalled(self) -> bool:
        return (self.clock() - self.last_beat) > self.timeout_s


@dataclass
class StragglerReport:
    step: int
    duration: float
    median: float
    ratio: float


class StragglerDetector:
    """Flags steps slower than ``threshold`` x rolling median.

    At cluster scale the same detector runs per-host on collective wait
    times; the mitigation hook decides re-shard / eject / ignore.
    """

    def __init__(self, threshold: float = 2.0, window: int = 32,
                 min_samples: int = 5):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self.durations: List[float] = []
        self.reports: List[StragglerReport] = []
        self._step = 0

    def record(self, duration: float) -> Optional[StragglerReport]:
        self._step += 1
        history = self.durations[-self.window:]
        self.durations.append(duration)
        if len(history) < self.min_samples:
            return None
        med = sorted(history)[len(history) // 2]
        if med > 0 and duration > self.threshold * med:
            rep = StragglerReport(step=self._step, duration=duration,
                                  median=med, ratio=duration / med)
            self.reports.append(rep)
            return rep
        return None

    @property
    def straggler_fraction(self) -> float:
        return len(self.reports) / max(1, self._step)


def run_with_retries(
    step_fn: Callable[[Any], Any],
    state: Any,
    *,
    restore_fn: Callable[[], Any],
    checkpoint_fn: Optional[Callable[[Any], None]] = None,
    max_retries: int = 3,
    on_failure: Optional[Callable[[BaseException, int], None]] = None,
) -> Any:
    """Run one step with recovery: on exception, restore + retry.

    Mirrors the coordinator loop of a real deployment: the step function
    is pure (state in, state out), so recovery is restore-and-replay.
    """
    attempt = 0
    while True:
        try:
            return step_fn(state)
        except Exception as e:          # noqa: BLE001 — recovery boundary
            attempt += 1
            if on_failure is not None:
                on_failure(e, attempt)
            if attempt > max_retries:
                raise
            state = restore_fn()


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    lost_devices: int
    batch_per_replica_change: float
    needs_reshard: bool
    note: str = ""


def elastic_plan(
    old_shape: Sequence[int],
    axes: Sequence[str],
    surviving_devices: int,
    *,
    keep_model_axis: bool = True,
) -> ElasticPlan:
    """Choose the new mesh after failures.

    Policy: the ``model`` axis carries intra-layer sharding whose reshape
    would re-layout every weight, so keep it; shrink the data axis to the
    largest size the survivors support.  (pod, data, model) meshes fold
    the pod axis into data first.
    """
    old_shape = tuple(old_shape)
    axes = tuple(axes)
    total_old = math.prod(old_shape)
    sizes = dict(zip(axes, old_shape))
    model = sizes.get("model", 1)
    if not keep_model_axis:
        model = 1
    if surviving_devices < model:
        raise ValueError(
            f"survivors ({surviving_devices}) cannot host the model axis "
            f"({model}); full re-plan required")
    new_data = surviving_devices // model
    # fold pods into data on shrink
    new_shape_map = {"data": new_data, "model": model}
    new_axes = tuple(a for a in axes if a in new_shape_map) or ("data", "model")
    new_shape = tuple(new_shape_map[a] for a in new_axes)
    used = new_data * model
    return ElasticPlan(
        old_shape=old_shape,
        new_shape=new_shape,
        axes=new_axes,
        lost_devices=total_old - surviving_devices,
        batch_per_replica_change=(sizes.get("data", 1)
                                  * sizes.get("pod", 1)) / max(1, new_data),
        needs_reshard=True,
        note=(f"dropping {surviving_devices - used} spare devices"
              if used != surviving_devices else ""),
    )
