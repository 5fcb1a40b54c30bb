"""Draft-free self-speculative proposal: prompt-lookup n-gram drafting.

A copy of the JAX package's ``repro.serve.speculate`` (host-only code;
the port keeps its own so that it imports nothing of that package).

The decode roofline says a paged decode step is bandwidth-bound — the
page fetches and weight streams dominate, the per-token FLOPs are
noise.  Verifying K drafted tokens through the multi-query kernel
therefore rides the SAME page traffic as one decode step (the paper's
amortise-per-access-overhead lever at the serving layer).  All that is
missing is a source of drafts that costs no extra model: this module
drafts from the sequence's own history ("prompt lookup"): if the last
``n`` committed tokens also occur earlier in the prompt + generation,
the tokens that followed that earlier occurrence are a cheap guess at
what greedy decode emits next.  Repetitive traffic (templated prompts,
quoting, code) accepts most drafts; adversarial traffic rejects at
position 0 and degenerates to ordinary decode — correctness never
depends on acceptance, only throughput does.

N-grams are content-addressed exactly like the JAX package's
``paging.prefix_cache`` pages: a blake2b digest of the int32 token ids
(the same rolling-hash machinery, at n-gram instead of page
granularity), so the per-request index is a flat ``digest -> end
position`` dict that grows incrementally as tokens commit — no rescan
of the resident pages, and a collision-free match for any realistic
vocabulary.

The proposer is deliberately host-side and stateful-per-request: the
engine calls :meth:`NgramProposer.propose` with the slot's committed
history before each speculative step and :meth:`NgramProposer.drop`
when the request finishes or is evicted.  History is append-only
(rejected drafts are never committed), so index entries never go
stale — a parked/resumed request keeps its index.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Hashable, List, Sequence

import numpy as np

__all__ = ["NgramProposer", "ngram_key"]


def ngram_key(tokens: Sequence[int]) -> bytes:
    """Content address of one n-gram — the ``prefix_cache.page_hashes``
    digest (blake2b-16 over int32 ids) applied at n-gram granularity."""
    arr = np.ascontiguousarray(tokens, dtype=np.int32)
    return hashlib.blake2b(arr.tobytes(), digest_size=16).digest()


class _Index:
    """Incremental n-gram index over one request's committed history."""

    __slots__ = ("upto", "last")

    def __init__(self) -> None:
        self.upto = 0              # history length already indexed
        self.last: Dict[bytes, int] = {}   # digest -> latest end position


class NgramProposer:
    """Prompt-lookup drafting: propose up to ``k`` tokens per slot by
    matching the history's trailing ``n``-gram against its most recent
    earlier occurrence.

    >>> p = NgramProposer(n=2, k=3)
    >>> p.propose("r", [5, 6, 7, 8, 5, 6])      # ...5,6 seen before -> 7,8,5
    [7, 8, 5]
    >>> p.propose("r", [1, 2, 3, 4, 5, 6])      # no earlier 5,6
    []
    """

    def __init__(self, n: int = 3, k: int = 4) -> None:
        if n < 1 or k < 1:
            raise ValueError(f"NgramProposer needs n >= 1, k >= 1 "
                             f"(got n={n}, k={k})")
        self.n = int(n)
        self.k = int(k)
        self._idx: Dict[Hashable, _Index] = {}

    def propose(self, rid: Hashable, history: Sequence[int]) -> List[int]:
        """Draft up to ``k`` tokens following ``history``.

        ``history`` must be the slot's full committed context (prompt +
        generated) and append-only across calls for the same ``rid``.
        Returns ``[]`` when the trailing n-gram has no earlier
        occurrence (or history is shorter than ``n``) — the engine then
        runs this slot as plain decode.
        """
        n = self.n
        hist = list(history)
        L = len(hist)
        idx = self._idx.setdefault(rid, _Index())
        # index every n-gram ending at positions (n .. L-1]; the one
        # ending at L is looked up first, then indexed, so a match is
        # always a strictly earlier occurrence
        for end in range(max(n, idx.upto + 1), L):
            idx.last[ngram_key(hist[end - n:end])] = end
        idx.upto = max(idx.upto, L - 1 if L else 0)
        if L < n:
            return []
        key = ngram_key(hist[L - n:])
        match = idx.last.get(key)
        idx.last[key] = L
        idx.upto = L
        if match is None:
            return []
        return hist[match:match + self.k]

    def drop(self, rid: Hashable) -> None:
        """Forget a finished/evicted request's index."""
        self._idx.pop(rid, None)
