"""Unified mapper engine: one entry point over the port's solver backends.

Port of ``repro/core/engine.py``:

    solve(rg, df, method="leastcost_torch", **cfg) -> (Mapping | None, Stats)
    solve_batch(rg, dfs, **cfg)                    -> (list[Mapping | None], Stats)
    solve_batch_dispatch(rg, dfs, **cfg)           -> PendingBatchSolve

Registered methods in this slice:

  ``leastcost_python``  faithful path-carrying LeastCostMap (§3.4.1)
  ``leastcost_torch``   tensorized (min,+) DP; every superstep is the CUDA
                        kernel on a CUDA device, its plain version on the CPU

``view=`` (region-local compacted solves) is accepted for the reference's
signature but must be None until ``core/compact.py`` is ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from .graph import DataflowPath, Mapping, ResourceGraph


@dataclasses.dataclass
class Stats:
    """Backend-independent solve statistics.

    Fields not meaningful for a backend keep their zero default.
    """

    method: str = ""
    rounds: int = 0  # relaxation rounds / BSP supersteps
    messages_sent: int = 0
    messages_processed: int = 0
    messages_pruned: int = 0
    messages_cross_device: int = 0
    max_set_size: int = 0  # peak live partial-map states
    maps_generated: int = 0
    fallback_used: bool = False  # tensorized backends: path-carrying rescue
    validated: bool = True
    kernel_impl: str = ""  # leastcost_torch: "cuda" | "plain"
    virtual_time: float = 0.0
    solve_ms: float = 0.0  # wall clock inside the backend (device + reconstruct)
    # host-side admission overhead: validation / reserve / commit loops
    overhead_ms: float = 0.0
    # wall clock spent re-solving optimistic-concurrency conflicts
    conflict_resolve_ms: float = 0.0
    # batches whose in-flight solve was invalidated by a churn/restore epoch
    stale_batches: int = 0
    batch_size: int = 1
    solve_n: int = 0  # node dimension the solve actually ran over
    preemptions: int = 0
    defrag_rounds: int = 0
    gossip_messages: int = 0
    twopc_messages: int = 0


def _unify(native, method: str) -> Stats:
    """Map any backend's native stats object onto the unified Stats."""
    s = Stats(method=method)
    if native is None:
        return s
    s.rounds = int(getattr(native, "rounds", 0) or getattr(native, "supersteps", 0))
    s.messages_sent = int(
        getattr(native, "messages_sent", 0) or getattr(native, "messages_total", 0)
    )
    s.messages_processed = int(getattr(native, "messages_processed", 0))
    s.messages_pruned = int(getattr(native, "messages_pruned", 0))
    s.messages_cross_device = int(getattr(native, "messages_cross_device", 0))
    s.max_set_size = int(getattr(native, "max_set_size", 0))
    s.maps_generated = int(getattr(native, "total_maps_generated", 0))
    s.fallback_used = bool(getattr(native, "fallback_used", False))
    s.validated = bool(getattr(native, "validated", True))
    s.kernel_impl = str(getattr(native, "kernel_impl", ""))
    s.virtual_time = float(
        getattr(native, "completed_at", None) or getattr(native, "virtual_time", 0.0)
    )
    s.preemptions = int(getattr(native, "preempted", 0))
    s.defrag_rounds = int(getattr(native, "defrag_rounds", 0))
    s.gossip_messages = int(getattr(native, "gossip_messages", 0))
    s.twopc_messages = int(getattr(native, "twopc_messages", 0))
    return s


_REGISTRY: dict[str, Callable] = {}

# Backends that natively batch many requests into one solve in solve_batch
# (everything else falls back to a sequential loop).  Callers that shape
# their batches around native batching (OnlinePlacer's power-of-two
# bucketing, its device tensors) key off this set.
BATCHED_METHODS = frozenset({"leastcost_torch"})


def register(name: str):
    """Register ``fn(rg, df, **cfg) -> (Mapping | None, native_stats)``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def backends() -> list[str]:
    return sorted(_REGISTRY)


def _no_view(view) -> None:
    if view is not None:
        raise NotImplementedError(
            "view= compaction needs core/compact.py, not yet ported")


def solve(
    rg: ResourceGraph,
    df: DataflowPath,
    method: str = "leastcost_torch",
    view=None,
    **cfg,
) -> tuple[Optional[Mapping], Stats]:
    """Solve one mapping request with the named backend."""
    _no_view(view)
    try:
        fn = _REGISTRY[method]
    except KeyError:
        raise ValueError(
            f"unknown mapper backend {method!r}; registered: {backends()}"
        ) from None
    t0 = time.perf_counter()
    mapping, native = fn(rg, df, **cfg)
    stats = _unify(native, method)
    stats.solve_n = rg.n
    stats.solve_ms = 1e3 * (time.perf_counter() - t0)
    return mapping, stats


def solve_batch(
    rg: ResourceGraph,
    dfs: list[DataflowPath],
    method: str = "leastcost_torch",
    view=None,
    **cfg,
) -> tuple[list[Optional[Mapping]], Stats]:
    """Solve many requests against one shared network: one batched DP for
    ``leastcost_torch`` (mixed ``p`` padded), a sequential loop through
    :func:`solve` for every other backend."""
    _no_view(view)
    if not dfs:
        return [], Stats(method=method, batch_size=0)
    t0 = time.perf_counter()
    if method in BATCHED_METHODS:
        from .leastcost import leastcost_torch_batched

        stats = Stats(method=method)
        mappings = leastcost_torch_batched(rg, list(dfs), stats=stats, **cfg)
    else:
        cfg.pop("graph_tensors", None)  # host-loop backends have no device path
        cfg.pop("warm_starts", None)  # warm seeding is a batched-DP feature
        mappings = []
        stats = Stats(method=method)
        for df in dfs:
            m, st = solve(rg, df, method=method, **cfg)
            mappings.append(m)
            stats.messages_sent += st.messages_sent
            stats.rounds = max(stats.rounds, st.rounds)
            stats.max_set_size = max(stats.max_set_size, st.max_set_size)
            stats.fallback_used |= st.fallback_used
            stats.validated &= st.validated
            stats.preemptions += st.preemptions
            stats.defrag_rounds += st.defrag_rounds
            stats.kernel_impl = stats.kernel_impl or st.kernel_impl
    stats.solve_n = rg.n
    stats.batch_size = len(dfs)
    stats.solve_ms = 1e3 * (time.perf_counter() - t0)
    return mappings, stats


class PendingBatchSolve:
    """Handle for an asynchronously dispatched :func:`solve_batch`.

    Batched backends enqueue the device DP and return immediately; the host
    blocks only inside :meth:`finalize`.  Other backends solve synchronously
    at dispatch and finalize hands the stored result back."""

    def __init__(self, method: str, dfs, *, pending=None, ready=None,
                 dispatch_ms: float = 0.0):
        self.method = method
        self.dfs = dfs
        self._pending = pending  # leastcost.PendingDP (batched backends)
        self._ready = ready  # (mappings, Stats) (sync backends)
        self._dispatch_ms = dispatch_ms
        self._solve_n = pending.rg.n if pending is not None else None

    def finalize(self) -> tuple[list[Optional[Mapping]], Stats]:
        """Block until the solve completes; return ``(mappings, stats)``."""
        if self._ready is not None:
            return self._ready
        from .leastcost import leastcost_torch_batched_finalize

        t0 = time.perf_counter()
        stats = Stats(method=self.method)
        mappings = leastcost_torch_batched_finalize(self._pending, stats=stats)
        stats.solve_n = self._solve_n
        stats.batch_size = len(self.dfs)
        stats.solve_ms = self._dispatch_ms + 1e3 * (time.perf_counter() - t0)
        self._ready = (mappings, stats)
        self._pending = None
        return self._ready


def solve_batch_dispatch(
    rg: ResourceGraph,
    dfs: list[DataflowPath],
    method: str = "leastcost_torch",
    view=None,
    graph_tensors=None,
    **cfg,
) -> PendingBatchSolve:
    """Asynchronous :func:`solve_batch`: dispatch now, block at
    :meth:`PendingBatchSolve.finalize`.  ``graph_tensors`` injects
    device-resident network tensors (``core.residual.ResidualState``)."""
    _no_view(view)
    if not dfs:
        return PendingBatchSolve(method, [],
                                 ready=([], Stats(method=method, batch_size=0)))
    if method in BATCHED_METHODS:
        from .leastcost import leastcost_torch_batched_dispatch

        t0 = time.perf_counter()
        pending = leastcost_torch_batched_dispatch(
            rg, list(dfs), graph_tensors=graph_tensors, **cfg
        )
        return PendingBatchSolve(
            method, list(dfs), pending=pending,
            dispatch_ms=1e3 * (time.perf_counter() - t0),
        )
    ready = solve_batch(rg, list(dfs), method=method, **cfg)
    return PendingBatchSolve(method, list(dfs), ready=ready)


# ---------------------------------------------------------------------------
# Backend adapters
# ---------------------------------------------------------------------------


@register("leastcost_python")
def _leastcost_python(rg, df, **cfg):
    from .leastcost import leastcost_python

    return leastcost_python(rg, df, **cfg)


@register("leastcost_torch")
def _leastcost_torch(rg, df, **cfg):
    from .leastcost import leastcost_torch

    return leastcost_torch(rg, df, **cfg)
