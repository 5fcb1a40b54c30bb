"""Synthetic LM data pipeline with AMU-backed asynchronous prefetch.

The pipeline produces deterministic, *learnable* token streams (affine
recurrences over the vocab with per-sequence parameters) so the training
example shows a real loss curve, not noise.  :class:`SyntheticLM` is the
reference's generator, numpy throughout, so the same ``seed`` and
``start_step`` give the same batches bit for bit.

:class:`PrefetchingLoader` is the paper's programming model applied to
input data: host->device batch transfers are ``aload``-ed ``depth``
batches ahead through an :class:`~repro_torch.core.amu.AMU` on a
:class:`~repro_torch.core.amu.DeviceTransferBackend` (copies on a side
CUDA stream), and the training loop takes the next batch with a wait
that, when the copy has already landed, does not block: input pipeline
latency hides behind the step's compute.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.amu import (AMU, AccessConfig, DeviceTransferBackend,
                                  QoS, RequestState)

__all__ = ["SyntheticLM", "PrefetchingLoader", "make_loader"]


class SyntheticLM:
    """Deterministic learnable token stream.

    Each sequence follows ``x_{t+1} = (a * x_t + c) mod V`` with (a, c)
    drawn per sequence from a small pool — a next-token distribution a
    ~100M model learns within a few hundred steps.
    """

    def __init__(self, vocab: int, seq_len: int, batch: int, *,
                 seed: int = 0, start_step: int = 0, pool: int = 8,
                 extras: Optional[Dict[str, tuple]] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        # the *task* (pattern pool) depends only on ``seed``; the stream
        # position advances with ``start_step`` so resume continues the
        # same task rather than re-rolling it.
        pool_rng = np.random.default_rng(seed)
        self.pool_a = pool_rng.integers(2, 7, pool)
        self.pool_c = pool_rng.integers(1, vocab - 1, pool)
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, start_step]))
        self.extras = extras or {}
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, S, V = self.batch, self.seq_len, self.vocab
        which = self.rng.integers(0, len(self.pool_a), B)
        a = self.pool_a[which][:, None]
        c = self.pool_c[which][:, None]
        x0 = self.rng.integers(0, V, (B, 1))
        toks = np.empty((B, S + 1), np.int64)
        toks[:, :1] = x0
        for t in range(S):
            toks[:, t + 1] = (a[:, 0] * toks[:, t] + c[:, 0]) % V
        batch = {
            "tokens": toks[:, :S].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        for name, (shape, dtype) in self.extras.items():
            batch[name] = self.rng.standard_normal(
                (B,) + tuple(shape)).astype(dtype)
        self.step += 1
        return batch


def _with_positions(it: Iterator) -> Iterator[Dict[str, np.ndarray]]:
    """M-RoPE positions for a text stream: three equal (t, h, w) rows
    0..S-1, (3, B, S) int32."""
    for b in it:
        B, S = b["tokens"].shape
        b["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
        yield b


class PrefetchingLoader:
    """Wraps an iterator of host batches (dicts of numpy arrays); keeps
    ``depth`` batches' copies to ``device`` in flight, one ``aload`` an
    array.  ``counts()`` says how many arrays were loaded and how many of
    them had landed by the time the loop asked for them."""

    def __init__(self, it: Iterator, *, depth: int = 2, device="cuda",
                 amu: Optional[AMU] = None):
        self.it = it
        self.depth = depth
        self.amu = amu or AMU(backend=DeviceTransferBackend(device),
                              max_outstanding=max(2, depth * 2),
                              default_config=AccessConfig(
                                  granularity_bytes=1 << 20,
                                  qos=QoS.STANDARD))
        self._queue = []                # {name: rid} per batch, in order
        self._arrivals = collections.Counter()

    def _fill(self):
        while len(self._queue) < self.depth:
            try:
                host_batch = next(self.it)
            except StopIteration:
                break
            self._queue.append({k: self.amu.aload(v)
                                for k, v in host_batch.items()})

    def _landed(self, rid: int) -> bool:
        req = self.amu.request(rid)
        return req.state is RequestState.DONE or (
            req.state is RequestState.IN_FLIGHT
            and self.amu.backend.poll(req))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._queue:
            raise StopIteration
        rids = self._queue.pop(0)
        self._fill()
        out = {}
        for k, rid in rids.items():
            self._arrivals["landed" if self._landed(rid) else "waited"] += 1
            self.amu.wait(rid)
            out[k] = self.amu.result(rid)
        return out

    def counts(self) -> Dict[str, int]:
        """{"aloads": arrays issued, "landed": arrays whose copy was done
        when the loop asked for them, "waited": arrays it blocked on}."""
        return {"aloads": self.amu.stats["aload"],
                "landed": self._arrivals["landed"],
                "waited": self._arrivals["waited"]}


def make_loader(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                start_step: int = 0, device="cuda", depth: int = 2,
                skip: int = 0) -> PrefetchingLoader:
    """The training loader of ``cfg`` at ``shape``: :class:`SyntheticLM`
    from ``start_step`` (with M-RoPE positions for ``cfg.mrope_sections``
    and the encoder-decoder's ``src_embeds``), its first ``skip``
    batches dropped — a recovery replays its run's stream from the
    restored step — and the rest prefetched to ``device``."""
    extras = {}
    if cfg.family == "encdec":
        extras["src_embeds"] = ((shape.seq_len, cfg.d_model), np.float32)
    it = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     seed=seed, start_step=start_step, extras=extras)
    for _ in range(skip):
        next(it)
    if cfg.mrope_sections:
        it = _with_positions(it)
    return PrefetchingLoader(it, depth=depth, device=device)
