"""Engine configuration — the grouped, frozen construction API.

A copy of ``repro.serve.config``: one frozen :class:`EngineConfig` with
grouped sub-configs —

  * :class:`PagingConfig`    — the device page pool + far tier knobs,
  * :class:`ChunkingConfig`  — chunk-queue admission + prefix sharing,
  * :class:`SchedulerConfig` — scheduling policy, virtual clock, and the
    per-request SLO defaults the SLO-aware scheduler consumes,

— and the machinery that keeps every consumer in lockstep with it:
``launch/serve`` *auto-generates* its ``--`` flags from these dataclass
fields (:func:`add_config_args` / :func:`config_from_args`), and
:class:`VirtualClock` is the one injected time source every request
timestamp goes through.

The port's engine serves every admission path of the JAX engine: the
paged engine in every role (FUSED, and the PREFILL / DECODE halves of a
disaggregated pair), through the chunk queue or, with ``chunk_tokens``
unset or a prompt longer than the slot, the whole-prompt dense prefill
padded to ``prefill_buckets``, with speculative verify-K decode, the
int8/fp8 quantized pool, cross-request prefix sharing and
finished-sequence offload; and the non-paged engine
(``paging.enabled=False``: a dense per-slot cache, dense prefill only).
Two fields differ: ``device`` says where the engine's tensors live
(``cuda`` unless the caller asks for the CPU), and ``chunk_tokens``
defaults to 256 instead of unset, the chunk queue being the engine's
main path.

Example::

    from repro_torch.serve import Engine, EngineConfig, PagingConfig

    eng = Engine(cfg, params, EngineConfig(
        max_batch=4, max_len=256,
        paging=PagingConfig(page_size=16, device_pages=48),
        chunking=ChunkingConfig(chunk_tokens=32)))
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

from repro_torch.paging import WatermarkPolicy

__all__ = [
    "Tier", "EngineRole", "VirtualClock", "PagingConfig",
    "ChunkingConfig", "SchedulerConfig", "SpeculationConfig", "ObsConfig",
    "EngineConfig",
    "add_config_args", "config_from_args",
]


class Tier(enum.IntEnum):
    """Request priority tier — the production traffic split the SLO
    scheduler maps onto the paper's QoS classes (interactive traffic
    rides LATENCY-QoS far-memory fetches, batch rides BULK/STANDARD)."""

    INTERACTIVE = 0     # tight TTFT/TPOT SLOs; chat-style traffic
    BATCH = 1           # loose SLOs; shed first under overload


class EngineRole(str, enum.Enum):
    """Which half of the serving pipeline this engine runs.

    ``FUSED`` (default) is the classic single-engine pipeline — prefill
    and decode share one mesh and one device pool; bit-identical to the
    pre-role engine.  Under disaggregation (``docs/ARCHITECTURE.md``)
    a ``PREFILL`` engine graduates every request at its first token —
    the finished prompt pages BULK-park into the *shared*
    :class:`~repro_torch.core.offload.FarMemoryTier` and a
    :class:`~repro_torch.serve.disagg.HandoffRecord` is published — and
    a ``DECODE`` engine adopts records via
    :meth:`~repro_torch.serve.engine.Engine.admit_handoff`,
    LATENCY-fetching the parked state through the ordinary resume machinery.  The str
    values double as the auto-generated ``--role`` CLI choices."""

    FUSED = "fused"
    PREFILL = "prefill"
    DECODE = "decode"


class VirtualClock:
    """Deterministic injected clock: ``now`` advances only via
    :meth:`advance`.  The engine advances it by ``step_dt`` per event
    tick, in lockstep with the pager's simulated AMU backend, so every
    request timestamp (arrival, first token, per-token, completion)
    lives on one reproducible time axis.  Pass ``time.monotonic`` as
    ``SchedulerConfig.clock`` to get wall-clock telemetry instead."""

    def __init__(self, start: float = 0.0) -> None:
        self.now = float(start)

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now

    def __call__(self) -> float:
        return self.now


def _f(default, help_: str, *, cli: bool = True, choices=None, **kw):
    """Field with CLI metadata (help string, generation opt-out)."""
    md = {"help": help_, "cli": cli}
    if choices is not None:
        md["choices"] = choices
    if isinstance(default, (list, dict, set)):
        return field(default_factory=lambda: default, metadata=md)
    return field(default=default, metadata=md, **kw)


@dataclass(frozen=True)
class PagingConfig:
    """Device page pool + far tier: the near/far KV hierarchy knobs."""

    enabled: Optional[bool] = _f(
        None, "paged KV (None: auto — paged when the family has "
        "attention KV); False forces the dense per-slot cache", cli=False)
    page_size: int = _f(16, "KV page granularity in token positions")
    device_pages: Optional[int] = _f(
        None, "device page pool size; below max_batch * pages_per_seq "
        "the engine oversubscribes and preempts")
    hot_tail_pages: int = _f(
        1, "pages of a preempted sequence's hot tail kept pooled")
    offload_finished: bool = _f(
        False, "park finished KV in the host far tier (AMU)")
    kv_quant: str = _f(
        "none", "paged KV frame quantization: int8/fp8 frames with "
        "per-(frame, KV-head) scales, dequant fused into the page-gather "
        "kernels; 'none' is bit-identical to the unquantized engine",
        choices=("none", "int8", "fp8"))
    watermark: Optional[WatermarkPolicy] = _f(
        None, "free-page watermark policy object", cli=False)
    pager_factory: Optional[Callable] = _f(
        None, "custom Pager factory (tests: simulated-latency AMU)",
        cli=False)


@dataclass(frozen=True)
class ChunkingConfig:
    """Chunk-queue admission (chunked paged prefill) + prefix sharing."""

    chunk_tokens: Optional[int] = _f(
        256, "chunked paged prefill: prompt chunk size in tokens; "
        "unset = whole-prompt dense prefill at admission")
    chunk_slots: int = _f(
        2, "max admitting slots whose chunks fuse into one mixed "
        "prefill+decode step")
    prefix_cache: bool = _f(
        False, "content-addressed cross-request prefix sharing "
        "(requires chunk_tokens; dense/moe global-attention families)")


@dataclass(frozen=True)
class SpeculationConfig:
    """Draft-free self-speculative decode (prompt-lookup verify-K).

    With ``speculate_k > 0`` the paged engine drafts up to K tokens per
    slot from the slot's own committed history
    (:class:`~repro_torch.serve.speculate.NgramProposer`) and scores them
    all in one verify step through the multi-row paged kernel; greedy
    acceptance keeps the emitted stream token-exact with single-step
    decode, so this is purely a throughput knob.  Global attention only
    (no SWA)."""

    speculate_k: int = _f(
        0, "speculative decode: max drafted tokens per slot per step "
        "(0 = off; K drafts verify in one multi-query step)")
    speculate_ngram: int = _f(
        3, "prompt-lookup n-gram length the proposer matches on")
    proposer_factory: Optional[Callable] = _f(
        None, "custom draft proposer factory (tests: oracle/adversarial "
        "proposers); None = NgramProposer(speculate_ngram, speculate_k)",
        cli=False)


@dataclass(frozen=True)
class SchedulerConfig:
    """Scheduling policy + the SLO knobs the goodput scheduler consumes.

    ``policy="watermark"`` is the PR-4 scheduler: FIFO admission,
    newest-admitted-first preemption, admit-order chunk selection —
    utilization-maximizing, SLO-blind.  ``policy="slo"`` makes every
    one of those decisions deadline-aware: admission sheds batch-tier
    load first, preemption evicts the slot whose SLO is already blown
    or furthest from its deadline, chunk selection runs earliest
    TTFT deadline first, and the priority tier maps onto the pager's
    QoS windows (interactive fetches ride LATENCY, batch parks ride
    BULK) — §2.2 MACR QoS applied at request granularity."""

    policy: str = _f("watermark", "scheduling policy",
                     choices=("watermark", "slo"))
    step_dt: float = _f(
        1e-3, "virtual seconds one engine tick advances the clock "
        "(and the pager's simulated AMU backend)")
    ttft_slo: Optional[float] = _f(
        None, "default time-to-first-token SLO (virtual s) stamped on "
        "requests submitted without one")
    tpot_slo: Optional[float] = _f(
        None, "default time-per-output-token SLO (virtual s) stamped "
        "on requests submitted without one")
    batch_headroom: int = _f(
        2, "extra free pages (beyond the low watermark) a BATCH-tier "
        "admission must leave — the load-shedding margin")
    clock: Optional[Callable[[], float]] = _f(
        None, "injected clock; None = engine-owned VirtualClock "
        "advanced step_dt per tick (deterministic telemetry)", cli=False)


@dataclass(frozen=True)
class ObsConfig:
    """Telemetry (:mod:`repro_torch.obs`): the tracer rides the engine's one
    :class:`VirtualClock`, so AMU transfer spans, pager actions, and
    request lifecycle tracks share a single deterministic time axis.
    Tracing is off by default and costs one branch per call site when
    off; ``trace_out``/``metrics_out`` imply enabling it and write the
    Perfetto-loadable timeline / flat metrics JSON when ``run()``
    returns."""

    trace: bool = _f(
        False, "enable span/instant tracing even without --trace-out "
        "(events stay in memory on engine.tracer)")
    trace_out: Optional[str] = _f(
        None, "write a Chrome-trace/Perfetto JSON timeline here after "
        "run() (implies tracing on)")
    metrics_out: Optional[str] = _f(
        None, "write the flat metrics JSON (counters + gauges + "
        "histogram percentiles) here after run()")

    @property
    def tracing(self) -> bool:
        return bool(self.trace or self.trace_out)


@dataclass(frozen=True)
class EngineConfig:
    """Everything ``Engine.__init__`` takes besides the model + params."""

    max_batch: int = _f(4, "decode slots (fixed compiled batch)")
    max_len: int = _f(256, "per-sequence token capacity")
    prefill_buckets: Tuple[int, ...] = _f(
        (32, 64, 128, 256), "dense-prefill padding buckets "
        "(comma-separated on the CLI)")
    device: str = _f("cuda", "device the engine's tensors live on",
                     choices=("cuda", "cpu"))
    role: str = _f(
        "fused", "engine role: fused single-engine pipeline, or one "
        "half of a disaggregated prefill/decode pair over a shared "
        "far tier", choices=("fused", "prefill", "decode"))
    handoff: Any = _f(
        None, "HandoffBoard shared between a PREFILL and a DECODE "
        "engine (a PREFILL engine creates its own when None)",
        cli=False)
    paging: PagingConfig = field(default_factory=PagingConfig,
                                 metadata={"cli": True})
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig,
                                     metadata={"cli": True})
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig,
                                       metadata={"cli": True})
    speculation: SpeculationConfig = field(
        default_factory=SpeculationConfig, metadata={"cli": True})
    obs: ObsConfig = field(default_factory=ObsConfig,
                           metadata={"cli": True})


# -- CLI auto-generation ------------------------------------------------------
# launch/serve builds its --flags from the dataclass fields above, so a
# new knob lands on the CLI (with its help string) the moment it lands
# in the config — the API and the CLI cannot drift.

_GROUPS = ("paging", "chunking", "scheduler", "speculation", "obs")


def _cli_fields(dc_type):
    for fld in dataclasses.fields(dc_type):
        md = fld.metadata
        if not md.get("cli", False):
            continue
        if fld.name in _GROUPS:
            continue
        yield fld


def _scalar_type(fld):
    """CLI parse type for a field (Optional[X] unwraps to X)."""
    t = fld.type
    for base in ("int", "float", "str", "bool"):
        if t == base or t.startswith(f"Optional[{base}]"):
            return {"int": int, "float": float,
                    "str": str, "bool": bool}[base]
    if "Tuple[int" in t:
        return lambda s: tuple(int(x) for x in s.split(","))
    raise TypeError(f"field {fld.name}: no CLI mapping for type {t!r}")


def _default_of(fld):
    if fld.default is not dataclasses.MISSING:
        return fld.default
    return fld.default_factory()       # pragma: no cover - no such field


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Add one ``--flag`` per CLI-visible :class:`EngineConfig` field
    (top level + every sub-config; names are unique by construction)."""
    seen = set()
    for dc in (EngineConfig, PagingConfig, ChunkingConfig,
               SchedulerConfig, SpeculationConfig, ObsConfig):
        for fld in _cli_fields(dc):
            if fld.name in seen:
                raise TypeError(
                    f"duplicate CLI field name {fld.name!r} across "
                    "EngineConfig sub-configs")
            seen.add(fld.name)
            flag = "--" + fld.name.replace("_", "-")
            typ = _scalar_type(fld)
            default = _default_of(fld)
            help_ = fld.metadata.get("help", "")
            if typ is bool:
                parser.add_argument(flag, action="store_true",
                                    default=bool(default), help=help_)
            elif "Tuple" in fld.type:
                parser.add_argument(
                    flag, type=typ,
                    default=default, metavar="N,N,...",
                    help=help_ + f" (default {','.join(map(str, default))})")
            else:
                kw = {}
                if fld.metadata.get("choices"):
                    kw["choices"] = fld.metadata["choices"]
                parser.add_argument(flag, type=typ, default=default,
                                    help=help_ +
                                    (f" (default {default})"
                                     if default is not None else ""),
                                    **kw)


def config_from_args(args: argparse.Namespace, **overrides) -> EngineConfig:
    """Rebuild the nested :class:`EngineConfig` from parsed auto-generated
    flags; ``overrides`` paths like ``paging_enabled=False`` win last."""
    def build(dc_type):
        vals = {}
        for fld in _cli_fields(dc_type):
            if hasattr(args, fld.name):
                vals[fld.name] = getattr(args, fld.name)
        return vals

    paging = PagingConfig(**build(PagingConfig))
    chunking = ChunkingConfig(**build(ChunkingConfig))
    scheduler = SchedulerConfig(**build(SchedulerConfig))
    speculation = SpeculationConfig(**build(SpeculationConfig))
    obs = ObsConfig(**build(ObsConfig))
    cfg = EngineConfig(paging=paging, chunking=chunking,
                       scheduler=scheduler, speculation=speculation,
                       obs=obs, **build(EngineConfig))
    for path, value in overrides.items():
        group, _, fname = path.partition("_")
        if group in _GROUPS and fname:
            sub = dataclasses.replace(getattr(cfg, group), **{fname: value})
            cfg = dataclasses.replace(cfg, **{group: sub})
        else:
            cfg = dataclasses.replace(cfg, **{path: value})
    return cfg
