"""SolutionCache — tier 1 of the incremental admission fast path.

Copy of ``repro/core/solution_cache.py``.

Steady-state streams repeat request shapes, and churn re-admits the same
dataflows over a residual graph that has barely moved.  The cache keeps,
per canonical request signature, the *last committed mapping* so a
repeat admit can skip the batched (min,+) DP entirely.

Safety discipline (same as gossip / congestion estimates): the cache is
**advisory only**.  A positive hit is *always* re-validated against the
float64 host residual truth (``validate_mapping``) before any reserve,
so a stale entry can cause extra work but never an over-commit.
Negative entries ("this signature was just rejected") are only honored
at the **exact** ``(ResidualState.version, epoch)`` stamp they were
recorded under — the residual is versioned on every host mutation, so
an identical stamp means an identical residual and the deterministic DP
would reject again; any mutation invalidates the negative implicitly.

Entries live in the placer's id space.  Per-region placers operate on
``CompactedView``-local ids, so regional / hierarchical planes get
per-region caches for free, and the broker's spanning sub-segments
(admitted via ``placer.admit(view.compact_df(seg))``) ride the same
per-region cache.  The placer folds ``view.version`` into the epoch it
stamps with, so a view remap invalidates negatives automatically.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

from .graph import DataflowPath, Mapping

__all__ = ["SolutionCache", "request_signature"]

Signature = Tuple
Stamp = Tuple[int, int]  # (ResidualState.version, placer epoch)


def request_signature(df: DataflowPath) -> Signature:
    """Canonical signature of a request: length, per-node compute demands,
    per-edge bandwidth demands, and the src/dst pins — everything the DP
    reads from the request side of the problem.  Ids are whatever space
    the owning placer solves in (global for the flat plane, view-local
    for regional planes)."""
    return (df.p, int(df.src), int(df.dst),
            df.creq.tobytes(), df.breq.tobytes())


class SolutionCache:
    """LRU positive entries (signature -> last committed mapping) plus
    exact-stamp negative entries (signature -> rejection stamp)."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._pos: "OrderedDict[Signature, Mapping]" = OrderedDict()
        self._neg: "OrderedDict[Signature, Stamp]" = OrderedDict()

    # -- positive entries ------------------------------------------------------

    def get(self, sig: Signature) -> Optional[Mapping]:
        """Last committed mapping for ``sig``, or None.  The caller MUST
        re-validate against current residual truth before reserving."""
        m = self._pos.get(sig)
        if m is not None:
            self._pos.move_to_end(sig)
        return m

    def put(self, sig: Signature, mapping: Mapping) -> None:
        """Record a *committed* mapping; clears any negative for ``sig``
        (the commit itself proves the signature admissible)."""
        self._neg.pop(sig, None)
        self._pos[sig] = mapping
        self._pos.move_to_end(sig)
        while len(self._pos) > self.capacity:
            self._pos.popitem(last=False)

    # -- negative entries ------------------------------------------------------

    def put_negative(self, sig: Signature, stamp: Stamp) -> None:
        """Record a rejection observed at ``stamp``.  Only meaningful if
        the residual did not move between solve and record — the caller
        checks that."""
        self._neg[sig] = stamp
        self._neg.move_to_end(sig)
        while len(self._neg) > self.capacity:
            self._neg.popitem(last=False)

    def negative_hit(self, sig: Signature, stamp: Stamp) -> bool:
        """True iff ``sig`` was rejected at exactly this residual stamp.
        Sound (identical residual => the deterministic solve rejects
        again) and can only ever under-admit by zero: any host mutation
        bumps the version, so the entry simply stops matching."""
        return self._neg.get(sig) == stamp

    # -- maintenance -----------------------------------------------------------

    def drop(self, sig: Signature) -> None:
        self._pos.pop(sig, None)
        self._neg.pop(sig, None)

    def clear(self) -> None:
        self._pos.clear()
        self._neg.clear()

    def __len__(self) -> int:
        return len(self._pos)

    @property
    def negatives(self) -> int:
        return len(self._neg)
