"""Problem data structures for BCPM/BCDM (paper §2).

Numpy copy of ``repro/core/graph.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the shared data structures.

A :class:`ResourceGraph` is an arbitrary network of compute nodes (capacity
``cap``) and links (bandwidth ``bw``, additive latency ``lat``).  A
:class:`DataflowPath` is a linear dataflow computation: ``p`` nodes with
compute requirements ``creq`` and ``p-1`` edges with bandwidth requirements
``breq``.  Endpoints are pinned (``M(0)=src``, ``M(p-1)=dst``).

Dense float32 matrices are used throughout so the same objects feed the
Python reference algorithms, the tensorized DP and the CUDA kernel.
``INF`` marks absent links / infeasible states (min-plus absorbing element).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class ResourceGraph:
    """Arbitrary resource network (paper Fig. 1).

    Attributes:
      cap: (n,) float32 — available computational capacity ``C_av`` per node.
      bw:  (n, n) float32 — available bandwidth ``B_av`` per directed link;
        0 where no link exists.
      lat: (n, n) float32 — additive latency ``D`` per directed link; INF
        where no link exists.  Diagonal is 0 (zero-length paths, paper §2.1).
    """

    cap: np.ndarray
    bw: np.ndarray
    lat: np.ndarray

    def __post_init__(self):
        n = self.cap.shape[0]
        assert self.bw.shape == (n, n) and self.lat.shape == (n, n)

    @property
    def n(self) -> int:
        return int(self.cap.shape[0])

    @property
    def num_edges(self) -> int:
        return int(np.count_nonzero(np.isfinite(self.lat) & ~np.eye(self.n, dtype=bool)))

    def edges(self) -> Iterable[tuple[int, int]]:
        """Directed edges (u, v), u != v, in deterministic order."""
        fin = np.isfinite(self.lat) & ~np.eye(self.n, dtype=bool)
        for u, v in zip(*np.nonzero(fin)):
            yield int(u), int(v)

    def neighbors(self, u: int) -> list[int]:
        fin = np.isfinite(self.lat[u]) & (np.arange(self.n) != u)
        return [int(v) for v in np.nonzero(fin)[0]]

    @staticmethod
    def from_edge_list(
        cap: Sequence[float],
        edges: Sequence[tuple[int, int, float, float]],
        symmetric: bool = True,
    ) -> "ResourceGraph":
        """Build from ``(u, v, bandwidth, latency)`` tuples."""
        n = len(cap)
        bw = np.zeros((n, n), np.float32)
        lat = np.full((n, n), INF, np.float32)
        np.fill_diagonal(lat, 0.0)
        for u, v, b, l in edges:
            bw[u, v] = b
            lat[u, v] = l
            if symmetric:
                bw[v, u] = b
                lat[v, u] = l
        return ResourceGraph(np.asarray(cap, np.float32), bw, lat)


@dataclasses.dataclass(frozen=True)
class DataflowPath:
    """Linear dataflow computation (paper Fig. 3) with pinned endpoints.

    Attributes:
      creq: (p,) float32 — compute requirement per dataflow node (source and
        sink included; commonly 0 for them).
      breq: (p-1,) float32 — bandwidth requirement of dataflow edge (i, i+1).
      src, dst: pinned resource-node ids for dataflow nodes 0 and p-1.
    """

    creq: np.ndarray
    breq: np.ndarray
    src: int
    dst: int

    def __post_init__(self):
        assert self.breq.shape[0] == self.creq.shape[0] - 1

    @property
    def p(self) -> int:
        return int(self.creq.shape[0])

    @staticmethod
    def make(creq: Sequence[float], breq: Sequence[float], src: int, dst: int) -> "DataflowPath":
        return DataflowPath(np.asarray(creq, np.float32), np.asarray(breq, np.float32), src, dst)


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A complete mapping of a DataflowPath onto a ResourceGraph.

    ``assign[i]`` = resource node hosting dataflow node ``i``.  ``route`` is
    the simple resource path traversed (consecutive duplicates removed); it
    visits every assigned node in order.  ``cost`` = summed link latency.
    """

    assign: tuple[int, ...]
    route: tuple[int, ...]
    cost: float


def route_from_assign(assign: Sequence[int]) -> tuple[int, ...]:
    """Collapse consecutive duplicates: the resource route of a co-located run."""
    route = []
    for v in assign:
        if not route or route[-1] != v:
            route.append(int(v))
    return tuple(route)


def mapping_cost(rg: ResourceGraph, route: Sequence[int]) -> float:
    c = 0.0
    for u, v in zip(route[:-1], route[1:]):
        c += float(rg.lat[u, v])
    return c


def validate_mapping(
    rg: ResourceGraph, df: DataflowPath, mapping: Mapping, *, require_simple: bool = True
) -> tuple[bool, str]:
    """Check all BCPM constraints (paper §2.1/§2.2). Returns (ok, reason).

    - endpoints pinned;
    - route edges exist;
    - route is simple (the paper's cycle-avoidance; co-location collapses
      count as one visit);
    - cumulative capacity: total creq mapped on a resource node <= cap;
    - bandwidth: every resource edge carrying dataflow edge (i,i+1) has
      bw >= breq[i];
    - cost consistent with route latency.
    """
    from .problem import EPS_CAP_F32  # function-local: graph is problem's dep

    assign, route = mapping.assign, mapping.route
    p = df.p
    if len(assign) != p:
        return False, "assign length"
    if assign[0] != df.src or assign[-1] != df.dst:
        return False, "endpoints not pinned"
    if route != route_from_assign(assign):
        # Route may include pass-through nodes hosting no computation; it must
        # still visit assigned nodes in order as a supersequence.
        it = iter(route)
        for v in route_from_assign(assign):
            for w in it:
                if w == v:
                    break
            else:
                return False, "route does not visit assigned nodes in order"
    if require_simple and len(set(route)) != len(route):
        return False, "route revisits a node"
    for u, v in zip(route[:-1], route[1:]):
        if not np.isfinite(rg.lat[u, v]) or u == v:
            return False, f"missing link ({u},{v})"
    # Cumulative capacity.
    used: dict[int, float] = {}
    for i, v in enumerate(assign):
        used[v] = used.get(v, 0.0) + float(df.creq[i])
    for v, c in used.items():
        if c > float(rg.cap[v]) + EPS_CAP_F32:
            return False, f"capacity exceeded at node {v}"
    # Bandwidth: walk the route; dataflow edge index advances when the
    # assigned node changes.  Pass-through hops carry the current edge.
    pos = 0  # dataflow node index whose outgoing edge is being carried
    for u, v in zip(route[:-1], route[1:]):
        # advance pos to the last dataflow node assigned at u
        while pos + 1 < p and assign[pos + 1] == u:
            pos += 1
        if pos >= p - 1:
            return False, "route continues past sink"
        if float(rg.bw[u, v]) + EPS_CAP_F32 < float(df.breq[pos]):
            return False, f"bandwidth violated on ({u},{v}) for dataflow edge {pos}"
    expect = mapping_cost(rg, route)
    if abs(expect - mapping.cost) > 1e-4 * max(1.0, abs(expect)):
        return False, f"cost mismatch {mapping.cost} vs {expect}"
    return True, "ok"
