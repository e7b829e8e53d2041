"""Unified mapper engine: one entry point over the port's solver backends.

Port of ``repro/core/engine.py``:

    solve(rg, df, method="leastcost_torch", **cfg) -> (Mapping | None, Stats)
    solve_batch(rg, dfs, **cfg)                    -> (list[Mapping | None], Stats)
    solve_batch_dispatch(rg, dfs, **cfg)           -> PendingBatchSolve

Registered methods:

  ``exact``             paper-faithful PathMap (Alg. 1-3), numpy
  ``simulate``          asynchronous message-passing simulator (Alg. 4), numpy
  ``leastcost_python``  faithful path-carrying LeastCostMap (§3.4.1)
  ``anneal``            AnnealedLeastCostMap (§3.4.2), numpy
  ``random_k``          RandomNeighbor (§3.4.3), numpy
  ``leastcost_torch``   tensorized (min,+) DP; every superstep is the CUDA
                        kernel on a CUDA device, its plain version on the CPU
  ``shard_map``         the decentralized BSP engine over torch.distributed
                        ranks; its move is the masked min-plus CUDA kernel

``view=`` (a :class:`~repro_torch.core.compact.CompactedView`) makes any of
them a region-local solve over the view's compacted ``n_r``-node slice.
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


def solve(
    rg: ResourceGraph,
    df: DataflowPath,
    method: str = "leastcost_torch",
    view=None,
    **cfg,
) -> tuple[Optional[Mapping], Stats]:
    """Solve one mapping request with the named backend.

    ``view`` (a :class:`~repro_torch.core.compact.CompactedView`) makes this
    a *region-local* solve: ``rg`` and ``df`` stay in global ids, but the
    backend runs over the view's compacted ``n_r``-node slice and the
    returned mapping is lifted back to global ids.  ``Stats.solve_n``
    records the node dimension the backend actually saw.
    """
    try:
        fn = _REGISTRY[method]
    except KeyError:
        raise ValueError(
            f"unknown mapper backend {method!r}; registered: {backends()}"
        ) from None
    t0 = time.perf_counter()
    if view is not None and not view.is_identity:
        mapping, native = fn(view.compact_graph(rg), view.compact_df(df), **cfg)
        if mapping is not None:
            mapping = view.uncompact_mapping(mapping)
        solve_n = view.n_local
    else:
        mapping, native = fn(rg, df, **cfg)
        solve_n = rg.n
    stats = _unify(native, method)
    stats.solve_n = solve_n
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
    :func:`solve` for every other backend.

    ``view`` compacts the whole batch into the view's local id space
    before solving (every request's endpoints must live in the view):
    tiles pad to the region-local ``n_r``, mappings come back global."""
    if not dfs:
        return [], Stats(method=method, batch_size=0)
    t0 = time.perf_counter()
    if view is not None and not view.is_identity:
        rg = view.compact_graph(rg)
        dfs = [view.compact_df(d) for d in dfs]
    if method in BATCHED_METHODS:
        from .leastcost import leastcost_torch_batched

        # warm-start seeds live in the caller's (already-local) id space;
        # they cannot survive a view compaction done here
        assert view is None or view.is_identity or "warm_starts" not in cfg
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
    if view is not None and not view.is_identity:
        mappings = [
            view.uncompact_mapping(m) if m is not None else None
            for m in mappings
        ]
    stats.solve_n = rg.n
    stats.batch_size = len(dfs)
    stats.solve_ms = 1e3 * (time.perf_counter() - t0)
    return mappings, stats


class PendingBatchSolve:
    """Handle for an asynchronously dispatched :func:`solve_batch`.

    Batched backends enqueue the device DP and return immediately; the host
    blocks only inside :meth:`finalize`.  Other backends solve synchronously
    at dispatch and finalize hands the stored result back."""

    def __init__(self, method: str, view, dfs, *, pending=None, ready=None,
                 dispatch_ms: float = 0.0):
        self.method = method
        self.view = view
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
        if self.view is not None and not self.view.is_identity:
            mappings = [
                self.view.uncompact_mapping(m) if m is not None else None
                for m in mappings
            ]
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
    if not dfs:
        return PendingBatchSolve(method, view, [],
                                 ready=([], Stats(method=method, batch_size=0)))
    if method in BATCHED_METHODS:
        from .leastcost import leastcost_torch_batched_dispatch

        t0 = time.perf_counter()
        if view is not None and not view.is_identity:
            assert graph_tensors is None, "view compaction vs device tensors"
            assert "warm_starts" not in cfg, "warm seeds vs view compaction"
            rg = view.compact_graph(rg)
            dfs = [view.compact_df(d) for d in dfs]
        pending = leastcost_torch_batched_dispatch(
            rg, list(dfs), graph_tensors=graph_tensors, **cfg
        )
        return PendingBatchSolve(
            method, view, list(dfs), pending=pending,
            dispatch_ms=1e3 * (time.perf_counter() - t0),
        )
    ready = solve_batch(rg, list(dfs), method=method, view=view, **cfg)
    return PendingBatchSolve(method, view, list(dfs), ready=ready)


# ---------------------------------------------------------------------------
# Backend adapters
# ---------------------------------------------------------------------------


@register("exact")
def _exact(rg, df, **cfg):
    from .exact import pathmap_exact

    return pathmap_exact(rg, df, **cfg)


@register("simulate")
def _simulate(rg, df, **cfg):
    from .simulator import SimConfig, simulate

    sim_cfg = cfg.pop("cfg", None) or SimConfig(**cfg)
    return simulate(rg, df, sim_cfg)


@register("leastcost_python")
def _leastcost_python(rg, df, **cfg):
    from .leastcost import leastcost_python

    return leastcost_python(rg, df, **cfg)


@register("anneal")
def _anneal(rg, df, **cfg):
    from .heuristics import anneal_python

    return anneal_python(rg, df, **cfg)


@register("random_k")
def _random_k(rg, df, **cfg):
    from .heuristics import random_k_python

    return random_k_python(rg, df, **cfg)


@register("leastcost_torch")
def _leastcost_torch(rg, df, **cfg):
    from .leastcost import leastcost_torch

    return leastcost_torch(rg, df, **cfg)


@register("shard_map")
def _shard_map_backend(rg, df, **cfg):
    from .distributed import leastcost_shard_map

    return leastcost_shard_map(rg, df, **cfg)
