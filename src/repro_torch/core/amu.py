"""Asynchronous Memory access Unit (AMU) — the paper's contribution as a runtime.

The paper (Wang et al., CS.AR 2021) proposes an in-core unit that lets
software issue *asynchronous* variable-granularity memory requests
(``aload``/``astore``), poll for completions (``getfin``), and stage data in
a scratch-pad memory (SPM).  This module implements the paper's
*programming model* at the runtime level, where "far memory" is host DRAM
(behind PCIe):

  * :class:`AMU` — the unit: bounded outstanding-request queue, request ids,
    non-blocking ``getfin``, blocking ``wait``.
  * :class:`AccessConfig` — the paper's *Memory Access Configuration
    Register* (granularity, QoS class) and *Default Configuration Register*.

Two transfer backends are provided:

  * ``DeviceTransferBackend`` — real copies from pinned host memory to
    a CUDA device, issued on a side ``torch.cuda.Stream`` and
    observed through a ``torch.cuda.Event``: ``Event.query`` is the
    non-blocking poll behind ``getfin``, ``Event.synchronize`` the
    blocking wait.  The training loader (:mod:`repro_torch.data.
    pipeline`) moves its batches through it.  On the CPU it copies
    synchronously and every poll finds the copy done.
  * ``SimBackend`` — deterministic simulated-latency backend, the one on
    the serving engine's path (the pager builds ``AMU()`` with it), so
    queue behaviour under 300ns–10µs far-memory latency is testable on
    the CPU.
"""

from __future__ import annotations

import collections
import enum
import heapq
import itertools
import time
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, Deque, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.obs import NULL_TRACER

__all__ = [
    "QoS",
    "AccessConfig",
    "Request",
    "RequestState",
    "AMU",
    "AMUError",
    "QueueFullPolicy",
    "SimBackend",
    "DeviceTransferBackend",
    "FAILURE_CODE",
]

#: ``getfin`` returns this when no request has completed — the paper's
#: "failure code" (non-blocking poll must never stall the pipeline).
FAILURE_CODE: int = -1


class AMUError(RuntimeError):
    """Raised on invalid AMU usage (bad id, double-consume, queue misuse)."""


class QoS(enum.IntEnum):
    """QoS label carried in the Memory Access Configuration Register."""

    BULK = 0        # large background transfers (checkpoint, offload)
    STANDARD = 1    # normal tile/page traffic
    LATENCY = 2     # latency-critical (decode-path KV fetch)


class QueueFullPolicy(enum.Enum):
    """What ``aload``/``astore`` do when all outstanding slots are busy."""

    BLOCK = "block"      # wait for a completion (backpressure)
    FAIL = "fail"        # return FAILURE_CODE (caller retries — true async)


@dataclass(frozen=True)
class AccessConfig:
    """Memory Access Configuration Register contents.

    granularity_bytes
        The unit of transfer the request is split into.  The paper's
        *variable granularity*: small for latency-critical random access,
        large to exploit aggregated far-memory bandwidth.
    qos
        Priority class; the AMU engine issues LATENCY before STANDARD
        before BULK when link slots are contended.
    software_defined
        Free-form key/values forwarded to message-interface memory systems
        (paper §2.2 "software-defined configuration information").
    """

    granularity_bytes: int = 512
    qos: QoS = QoS.STANDARD
    software_defined: Dict[str, Any] = field(default_factory=dict)

    def with_granularity(self, nbytes: int) -> "AccessConfig":
        return replace(self, granularity_bytes=int(nbytes))


class RequestState(enum.Enum):
    PENDING = "pending"
    IN_FLIGHT = "in_flight"
    DONE = "done"
    CONSUMED = "consumed"     # returned by getfin/wait exactly once
    FAILED = "failed"


@dataclass
class Request:
    """One asynchronous request (the id in ``Rd`` of aload/astore)."""

    rid: int
    kind: str                     # "aload" | "astore"
    nbytes: int
    config: AccessConfig
    state: RequestState = RequestState.PENDING
    issue_t: float = 0.0
    start_t: float = 0.0          # backend start (0.0 = never started)
    done_t: float = 0.0
    payload: Any = None           # backend-specific handle / result
    error: Optional[BaseException] = None

    @property
    def latency(self) -> float:
        return self.done_t - self.issue_t if self.state in (
            RequestState.DONE, RequestState.CONSUMED) else float("nan")


# ---------------------------------------------------------------------------
# Transfer backends
# ---------------------------------------------------------------------------


class TransferBackend:
    """Moves bytes for the AMU.  start() must be non-blocking."""

    def start(self, req: Request) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def poll(self, req: Request) -> bool:
        """Return True iff ``req`` has completed (non-blocking)."""
        raise NotImplementedError

    def finish(self, req: Request) -> None:
        """Block until ``req`` completes."""
        raise NotImplementedError


class SimBackend(TransferBackend):
    """Deterministic simulated-latency backend (virtual clock).

    Latency model per request::

        t = base_latency + nbytes / bandwidth   (+ per-granule overhead)

    ``latency_fn`` may override ``base_latency`` per request to model the
    paper's *widely distributed* far-memory latency (e.g. sampled from a
    trace).  The virtual clock advances only via :meth:`advance`, keeping
    tests deterministic.
    """

    def __init__(
        self,
        base_latency: float = 1e-6,
        bandwidth: float = 10e9,
        granule_overhead: float = 0.0,
        latency_fn: Optional[Callable[[Request], float]] = None,
    ) -> None:
        self.base_latency = base_latency
        self.bandwidth = bandwidth
        self.granule_overhead = granule_overhead
        self.latency_fn = latency_fn
        self.now = 0.0
        self._done_at: Dict[int, float] = {}

    def transfer_time(self, req: Request) -> float:
        base = (self.latency_fn(req) if self.latency_fn is not None
                else self.base_latency)
        granules = max(1, -(-req.nbytes // max(1, req.config.granularity_bytes)))
        return base + req.nbytes / self.bandwidth + granules * self.granule_overhead

    def start(self, req: Request) -> None:
        if isinstance(req.payload, tuple) and len(req.payload) == 2:
            req.payload = req.payload[0]   # unwrap (src, memory_kind)
        self._done_at[req.rid] = self.now + self.transfer_time(req)

    def poll(self, req: Request) -> bool:
        return self.now >= self._done_at[req.rid]

    def finish(self, req: Request) -> None:
        self.now = max(self.now, self._done_at[req.rid])

    def advance(self, dt: float) -> None:
        self.now += dt


class _InFlight(NamedTuple):
    """A copy the side stream has queued: its destination, the event
    recorded after it, and the source kept alive until it lands."""
    out: torch.Tensor
    event: Any
    src: torch.Tensor


class DeviceTransferBackend(TransferBackend):
    """Real copies of host arrays to ``device``.

    An ``aload`` stages the host array in pinned memory and copies it to
    the device with ``non_blocking=True`` on a side stream; an event
    recorded after the copy is the request's completion: ``poll`` is
    ``event.query()``, ``finish`` is ``event.synchronize()``.  When a
    copy lands, the current (consuming) stream waits on its event and the
    result is ``record_stream``-ed on that stream, so the caching
    allocator does not hand its memory to a later copy while kernels on
    the consuming stream may still read it.  The request's payload is
    then the device tensor.  Only loads to the device move: a request
    for another memory kind (an ``astore`` to ``"pinned_host"``) raises.

    On a CPU ``device`` the copy is made synchronously at ``start`` and
    every poll finds it done.  The stream is made at the first copy,
    never at construction or import.
    """

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self._stream = None

    def start(self, req: Request) -> None:
        src, memory_kind = req.payload
        if memory_kind not in (None, "device"):
            raise ValueError(f"DeviceTransferBackend loads host arrays to "
                             f"the device; memory kind {memory_kind!r} asked")
        src = src if isinstance(src, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(src))
        if self.device.type != "cuda":
            req.payload = src.to(self.device, copy=True)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        src = src.pin_memory()
        with torch.cuda.stream(self._stream):
            out = src.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        req.payload = _InFlight(out, event, src)

    def _land(self, req: Request) -> None:
        flight = req.payload
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(flight.event)
        flight.out.record_stream(stream)
        req.payload = flight.out

    def poll(self, req: Request) -> bool:
        if not isinstance(req.payload, _InFlight):
            return True
        if not req.payload.event.query():
            return False
        self._land(req)
        return True

    def finish(self, req: Request) -> None:
        if isinstance(req.payload, _InFlight):
            req.payload.event.synchronize()
            self._land(req)


# ---------------------------------------------------------------------------
# The AMU proper
# ---------------------------------------------------------------------------


class AMU:
    """The Asynchronous Memory access Unit runtime.

    Mirrors the paper's architecture: a bounded number of outstanding
    request slots (hardware queue entries), per-request ids, a completion
    queue drained by ``getfin``, QoS-ordered issue, and configuration
    registers (``default_config`` = the paper's Default Configuration
    Register; per-call overrides = specifying a config register in the
    instruction).
    """

    def __init__(
        self,
        backend: Optional[TransferBackend] = None,
        max_outstanding: int = 64,
        default_config: Optional[AccessConfig] = None,
        full_policy: QueueFullPolicy = QueueFullPolicy.BLOCK,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        metrics=None,
    ) -> None:
        if max_outstanding < 1:
            raise AMUError("max_outstanding must be >= 1")
        self.backend = backend or SimBackend()
        self.max_outstanding = max_outstanding
        self.default_config = default_config or AccessConfig()
        self.full_policy = full_policy
        self._clock = (self.backend_clock
                       if isinstance(self.backend, SimBackend) else clock)
        self._ids = itertools.count()
        self._requests: Dict[int, Request] = {}
        self._issue_q: List[Tuple[int, int, int]] = []   # (-qos, seq, rid)
        self._seq = itertools.count()
        self._in_flight: Dict[int, Request] = {}
        self._completed: Deque[int] = collections.deque()
        self.stats = collections.Counter()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self._notes: Dict[int, dict] = {}   # rid -> extra span args

    def annotate(self, rid: int, **kw) -> None:
        """Attach key/values to the transfer span emitted when ``rid``
        retires (callers — the pager — tag seq/logical/window-wait).
        Only call under ``tracer.enabled`` — notes die with the span."""
        note = self._notes.get(rid)
        if note is None:
            note = self._notes[rid] = {}
        note.update(kw)

    # -- clocks ------------------------------------------------------------
    def backend_clock(self) -> float:
        return self.backend.now  # type: ignore[attr-defined]

    # -- issue path (aload / astore) ---------------------------------------
    def _issue(self, kind: str, nbytes: int, payload: Any,
               config: Optional[AccessConfig],
               qos: Optional[QoS] = None) -> int:
        cfg = config or self.default_config
        if qos is not None and qos != cfg.qos:
            cfg = replace(cfg, qos=QoS(qos))
        if nbytes <= 0:
            raise AMUError(f"{kind}: nbytes must be positive, got {nbytes}")
        if self.outstanding >= self.max_outstanding:
            if self.full_policy is QueueFullPolicy.FAIL:
                self.stats["rejected"] += 1
                return FAILURE_CODE
            self._wait_for_slot()
        rid = next(self._ids)
        req = Request(rid=rid, kind=kind, nbytes=nbytes, config=cfg,
                      issue_t=self._clock(), payload=payload)
        self._requests[rid] = req
        heapq.heappush(self._issue_q, (-int(cfg.qos), next(self._seq), rid))
        self.stats[kind] += 1
        self._pump()
        return rid

    def aload(self, src: Any = None, nbytes: int = 0,
              config: Optional[AccessConfig] = None,
              memory_kind: Optional[str] = "device",
              qos: Optional[QoS] = None) -> int:
        """Issue an asynchronous load (far memory → SPM/near tier).

        Returns the request id immediately (or FAILURE_CODE under the
        FAIL policy when all outstanding slots are busy).  ``qos``
        overrides only the QoS class of the effective config — the
        paper's per-instruction MACR override without callers having to
        rebuild a whole :class:`AccessConfig`.
        """
        nbytes = nbytes or _nbytes_of(src)
        return self._issue("aload", nbytes, (src, memory_kind), config, qos)

    def astore(self, src: Any = None, nbytes: int = 0,
               config: Optional[AccessConfig] = None,
               memory_kind: Optional[str] = "pinned_host",
               qos: Optional[QoS] = None) -> int:
        """Issue an asynchronous store (SPM/near tier → far memory)."""
        nbytes = nbytes or _nbytes_of(src)
        return self._issue("astore", nbytes, (src, memory_kind), config, qos)

    def _pump(self) -> None:
        """Move queued requests into flight and harvest completions."""
        while self._issue_q and len(self._in_flight) < self.max_outstanding:
            _, _, rid = heapq.heappop(self._issue_q)
            req = self._requests[rid]
            try:
                self.backend.start(req)
                req.state = RequestState.IN_FLIGHT
                req.start_t = self._clock()
                self._in_flight[rid] = req
            except BaseException as e:  # failed issue -> FAILED, poison req
                req.state = RequestState.FAILED
                req.error = e
                self._completed.append(rid)
                if self.tracer.enabled:
                    self.tracer.instant(
                        "amu", req.config.qos.name, "fault",
                        {"rid": rid, "kind": req.kind,
                         "nbytes": req.nbytes,
                         **self._notes.pop(rid, {})})
        for rid in list(self._in_flight):
            req = self._in_flight[rid]
            if self.backend.poll(req):
                self._retire(req)

    def _wait_for_slot(self) -> None:
        """Block until a slot frees.  Completions are *retired* into the
        completion queue (still observable via getfin) — never consumed."""
        self._pump()
        while self.outstanding >= self.max_outstanding and self._in_flight:
            rid = next(iter(self._in_flight))
            req = self._in_flight[rid]
            self.backend.finish(req)
            self._retire(req)
            self._pump()

    def _retire(self, req: Request) -> None:
        self._in_flight.pop(req.rid, None)
        req.state = RequestState.DONE
        req.done_t = self._clock()
        self._completed.append(req.rid)
        self.stats["completed"] += 1
        qos = req.config.qos.name
        if self.tracer.enabled:
            # one span per transfer, issue -> retire, on the QoS track
            # (queued_us = time waiting for a queue slot before the
            # backend started moving bytes)
            self.tracer.complete(
                "amu", qos, req.kind, req.issue_t, req.done_t,
                {"rid": req.rid, "nbytes": req.nbytes, "qos": qos,
                 "queued_us": (req.start_t - req.issue_t) * 1e6,
                 **self._notes.pop(req.rid, {})})
        if self.metrics is not None:
            self.metrics.observe(f"amu/latency_s/{req.kind}/{qos}",
                                 req.done_t - req.issue_t)

    # -- completion path (getfin / wait) ------------------------------------
    def getfin(self) -> int:
        """Non-blocking: id of one finished request, or FAILURE_CODE.

        This is the paper's ``getfin`` instruction: it never blocks, and
        each completed id is returned exactly once.
        """
        self._pump()
        if not self._completed:
            return FAILURE_CODE
        rid = self._completed.popleft()
        req = self._requests[rid]
        if req.state is RequestState.FAILED:
            raise AMUError(f"request {rid} failed") from req.error
        req.state = RequestState.CONSUMED
        return rid

    def wait(self, rid: int) -> Request:
        """Block until a *specific* request completes, consume and return it."""
        req = self._requests.get(rid)
        if req is None:
            raise AMUError(f"unknown request id {rid}")
        if req.state is RequestState.CONSUMED:
            raise AMUError(f"request {rid} already consumed")
        if req.state is RequestState.PENDING:
            # force it into flight ahead of queue order
            self._issue_q = [(q, s, r) for (q, s, r) in self._issue_q if r != rid]
            heapq.heapify(self._issue_q)
            self.backend.start(req)
            req.state = RequestState.IN_FLIGHT
            req.start_t = self._clock()
            self._in_flight[rid] = req
        if req.state is RequestState.IN_FLIGHT:
            self.backend.finish(req)
            self._retire(req)
        self._completed.remove(rid)
        req.state = RequestState.CONSUMED
        return req

    def wait_any(self) -> int:
        """Block until *some* request completes; return its id (consumed)."""
        self._pump()
        if self._completed:
            return self.getfin()
        if not self._in_flight:
            raise AMUError("wait_any with no requests in flight")
        # finish the earliest in-flight request
        rid = next(iter(self._in_flight))
        req = self._in_flight[rid]
        self.backend.finish(req)
        self._retire(req)
        return self.getfin()

    def drain(self) -> List[int]:
        """Wait for everything; return all completed ids in order."""
        out: List[int] = []
        while self.outstanding or self._completed:
            out.append(self.wait_any() if not self._completed else self.getfin())
        return out

    # -- introspection -------------------------------------------------------
    @property
    def outstanding(self) -> int:
        return len(self._in_flight) + len(self._issue_q)

    def request(self, rid: int) -> Request:
        try:
            return self._requests[rid]
        except KeyError:
            raise AMUError(f"unknown request id {rid}") from None

    def result(self, rid: int) -> Any:
        """Payload of a consumed request (the landed Array for aload)."""
        req = self.request(rid)
        if req.state is not RequestState.CONSUMED:
            raise AMUError(f"request {rid} not consumed yet (state={req.state})")
        return req.payload


def _nbytes_of(x: Any) -> int:
    if x is None:
        raise AMUError("nbytes or a sized src is required")
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    return int(np.asarray(x).nbytes)
