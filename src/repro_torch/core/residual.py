"""Device-resident residual tensors with a versioned host mirror.

Port of ``repro/core/residual.py``.  :class:`ResidualState` owns the online
placer's residual capacity/bandwidth state.  The float64 host arrays are the
source of truth — every commit/release mutates them immediately, and
validation at commit time always reads them — while the float32 tensors the
batched DP consumes (``cap``/``bw``/``lat`` with liveness applied) stay on
the device: commits accumulate into a small delta buffer that is applied as
one scatter-add the next time a solve is dispatched.

The scatter-add is out of place (``index_put(..., accumulate=True)`` returns
new tensors): a solve already dispatched keeps the tensors it was given, and
the supersteps its finalize enqueues later still see the residual as it was
at dispatch — the counterpart of JAX's immutable ``.at[].add``.  Deltas are
float32 values added in float32, as in the reference, so the mirror is
bitwise the reference's after the same commit/release sequence.

Two counters version the state:

- ``version`` bumps on **every** host mutation (commit, release, liveness
  change, restore);
- ``epoch`` bumps only on events that make an in-flight optimistic solve
  unsalvageable: liveness changes and :meth:`restore` rollbacks.  It is
  monotone and never restored from a snapshot.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import INF, ResourceGraph
from .problem import graph_tensors_of, to_device


class ResidualState:
    """Residual capacity/bandwidth of one resource network: float64 host
    truth + lazily synchronized float32 device tensors + staleness fences."""

    def __init__(self, base: ResourceGraph, *, device):
        self.base = base
        self.device = torch.device(device)
        n = base.n
        self.cap = base.cap.astype(np.float64).copy()
        self.bw = base.bw.astype(np.float64).copy()
        self.node_up = np.ones(n, bool)
        self.link_up = np.isfinite(base.lat) & ~np.eye(n, dtype=bool)
        self.version = 0  # bumps on every host mutation
        self.epoch = 0  # bumps only when in-flight solves become invalid
        self._dev: dict | None = None  # {"cap","bw","lat"} device tensors
        self._node_delta: dict[int, float] = {}  # node -> pending cap delta
        self._edge_delta: dict[tuple, float] = {}  # (u,v) -> pending bw delta
        # how often the device mirror paid a full O(n^2) upload vs an
        # O(delta) scatter-add
        self.sync_stats = {"full_uploads": 0, "delta_syncs": 0,
                           "invalidations": 0}

    # -- host truth ---------------------------------------------------------

    def residual_graph(self) -> ResourceGraph:
        """The network the next solve sees: committed capacity subtracted,
        failed nodes/links removed (cap 0 / bw 0 / lat INF)."""
        up2 = self.node_up[:, None] & self.node_up[None, :]
        alive = self.link_up & up2
        cap = np.where(self.node_up, self.cap, 0.0).astype(np.float32)
        bw = np.where(alive, self.bw, 0.0).astype(np.float32)
        lat = np.where(alive, self.base.lat, INF).astype(np.float32)
        np.fill_diagonal(lat, 0.0)
        return ResourceGraph(cap, bw, lat)

    def apply_load(self, node_load: dict, edge_load: dict, sign: float) -> None:
        """Commit (``sign=-1``) or release (``sign=+1``) a ticket's loads.

        Host arrays update immediately; the device mirror accumulates the
        delta and applies it as one scatter-add at the next dispatch."""
        for v, c in node_load.items():
            d = sign * c
            self.cap[v] += d
            if self._dev is not None and self.node_up[v]:
                self._node_delta[v] = self._node_delta.get(v, 0.0) + d
        for (u, v), b in edge_load.items():
            d = sign * b
            self.bw[u, v] += d
            if self._dev is not None and self.link_up[u, v]:
                key = (u, v)
                self._edge_delta[key] = self._edge_delta.get(key, 0.0) + d
        self.version += 1

    # -- liveness (drops the device cache: lat changes shape of the problem)

    def set_node_up(self, v: int, up: bool) -> None:
        self.node_up[v] = up
        self._invalidate()

    def set_link_up(self, u: int, v: int, up: bool) -> None:
        self.link_up[u, v] = self.link_up[v, u] = up
        self._invalidate()

    def _invalidate(self) -> None:
        """Liveness changed or state rolled back: fence out in-flight solves
        and force a full device re-upload on the next dispatch."""
        self.version += 1
        self.epoch += 1
        self._dev = None
        self._node_delta.clear()
        self._edge_delta.clear()
        self.sync_stats["invalidations"] += 1

    # -- snapshot / restore -------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "cap": self.cap.copy(),
            "bw": self.bw.copy(),
            "node_up": self.node_up.copy(),
            "link_up": self.link_up.copy(),
        }

    def restore(self, snap: dict) -> None:
        """Roll back to a snapshot.  ``epoch`` advances (never rewinds): any
        solve dispatched between snapshot and restore stays stale forever."""
        self.cap = snap["cap"].copy()
        self.bw = snap["bw"].copy()
        self.node_up = snap["node_up"].copy()
        self.link_up = snap["link_up"].copy()
        self._invalidate()

    # -- device mirror ------------------------------------------------------

    def device_tensors(self) -> dict:
        """Float32 ``{cap, bw, lat}`` of the current residual network.

        Full upload when the cache was dropped (construction, liveness
        change, restore); otherwise one out-of-place scatter-add per tensor
        over the pending commit/release deltas (unique indices, so the
        order of accumulation cannot change a bit)."""
        if self._dev is None:
            self._dev = graph_tensors_of(self.residual_graph(), self.device)
            self._node_delta.clear()
            self._edge_delta.clear()
            self.sync_stats["full_uploads"] += 1
            return self._dev
        if not (self._node_delta or self._edge_delta):
            return self._dev
        self.sync_stats["delta_syncs"] += 1
        dev = dict(self._dev)
        if self._node_delta:
            idx = np.fromiter(self._node_delta, np.int64, len(self._node_delta))
            val = np.fromiter(self._node_delta.values(), np.float32,
                              len(self._node_delta))
            dev["cap"] = dev["cap"].index_put(
                (to_device(idx, self.device),), to_device(val, self.device),
                accumulate=True)
            self._node_delta.clear()
        if self._edge_delta:
            uv = np.array(list(self._edge_delta), np.int64).reshape(-1, 2)
            val = np.fromiter(self._edge_delta.values(), np.float32,
                              len(self._edge_delta))
            dev["bw"] = dev["bw"].index_put(
                (to_device(uv[:, 0], self.device),
                 to_device(uv[:, 1], self.device)),
                to_device(val, self.device), accumulate=True)
            self._edge_delta.clear()
        self._dev = dev
        return self._dev
