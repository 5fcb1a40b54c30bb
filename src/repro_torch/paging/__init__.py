"""repro_torch.paging — page-granularity far-memory KV subsystem.

Host-side logic shared with the JAX package (a copy, not an import), in
three pieces that map one-to-one onto the source paper's architecture:

  * :mod:`repro_torch.paging.page_table` — the pool of device page frames
    (near tier / SPM) and per-sequence logical→physical maps with
    residency bits (APR-style per-page state),
  * :mod:`repro_torch.paging.pager` — the AMU traffic engine: LATENCY-QoS
    ``aload`` prefetch, BULK-QoS ``astore`` writeback, LRU-with-pinning
    eviction, and per-QoS outstanding windows (MACR QoS at issue),
  * :mod:`repro_torch.paging.events` — the §2.3.2 event-driven model as a
    scheduler: decode ticks, ``getfin`` page arrivals, and free-page-
    watermark admission/preemption decisions.

The serving engine (:mod:`repro_torch.serve.engine`) consumes all of it:
decode and chunked prefill both compute directly on the pool layout, so
the page is the unit of transfer, residency, eviction and compute.
"""

from repro_torch.paging.events import (DeadlineQueue, Event, EventKind,
                                       EventLoop, WatermarkPolicy)
from repro_torch.paging.page_table import (NOT_MAPPED, Frame, PagePool,
                                           PageState, PageTable, PagingError,
                                           pages_for)
from repro_torch.paging.pager import Pager, QoSWindows

__all__ = [
    "DeadlineQueue", "Event", "EventKind", "EventLoop", "WatermarkPolicy",
    "NOT_MAPPED", "Frame", "PagePool", "PageState", "PageTable",
    "PagingError", "pages_for", "Pager", "QoSWindows",
]
