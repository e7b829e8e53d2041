"""Tree-topology dataflow mapping — the paper's §4 proposed extension.

Port of ``repro/core/dag.py`` (numpy and scipy only).

The paper handles path topologies and names tree-shaped computations
(multi-source continual queries) as future work.  This module implements
that extension as a bottom-up dynamic program over the dataflow tree,
composing the path machinery:

  ``C[i][v]`` = min cost of mapping the subtree rooted at dataflow node ``i``
  with ``i`` placed on resource node ``v``:

  ``C[i][v] = [creq(i) <= cap(v)] * ( sum_children_c  min_u ( C[c][u] +
               bw-constrained-shortest-path_{breq(c,i)}(u -> v) ) )``

Like LeastCostMap this keeps one table entry per (dataflow node, resource
node); capacity is enforced per placement and *cumulatively re-validated* on
the reconstructed mapping (subtrees are combined independently, so two
subtrees may co-locate on one node; violations trigger a repair pass that
re-places offending nodes using their next-best table entries).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.sparse.csgraph import dijkstra
from scipy.sparse import csr_matrix

from .graph import ResourceGraph

BIGF = 1e18


@dataclasses.dataclass(frozen=True)
class DataflowTree:
    """In-tree dataflow: every node sends its stream to ``parent[i]``;
    ``parent[sink] = -1``.  ``breq[i]`` = bandwidth of edge (i -> parent[i]).
    ``pinned``: {dataflow node -> resource node} (sources + sink at minimum).
    """

    creq: np.ndarray  # (p,)
    parent: np.ndarray  # (p,) int, -1 at sink
    breq: np.ndarray  # (p,), breq[sink] unused
    pinned: dict[int, int]

    @property
    def p(self) -> int:
        return int(self.creq.shape[0])

    @property
    def sink(self) -> int:
        return int(np.nonzero(self.parent < 0)[0][0])

    def children(self, i: int) -> list[int]:
        return [int(c) for c in np.nonzero(self.parent == i)[0]]


@dataclasses.dataclass
class TreeMapping:
    assign: tuple[int, ...]
    cost: float
    valid: bool
    routes: dict[int, tuple[int, ...]]  # dataflow node -> route to its parent


def _bw_shortest_paths(rg: ResourceGraph, breq: float) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs shortest latency using only links with bw >= breq.

    Returns (dist, predecessors); O(n^2 log n) via scipy Dijkstra.
    """
    mask = (rg.bw >= breq) & np.isfinite(rg.lat) & (rg.lat > 0)
    w = np.where(mask, rg.lat, 0.0)
    dist, pred = dijkstra(
        csr_matrix(w), directed=True, return_predecessors=True
    )
    return dist, pred


def _extract_route(pred: np.ndarray, u: int, v: int) -> Optional[tuple[int, ...]]:
    if u == v:
        return (u,)
    route = [v]
    while route[-1] != u:
        p = pred[u, route[-1]]
        if p < 0:
            return None
        route.append(int(p))
    return tuple(reversed(route))


def treemap_leastcost(
    rg: ResourceGraph, tree: DataflowTree
) -> Optional[TreeMapping]:
    """Bottom-up LeastCostMap-style DP for tree dataflows."""
    p, n = tree.p, rg.n
    sink = tree.sink
    # Cache shortest paths per distinct bandwidth requirement.
    sp_cache: dict[float, tuple[np.ndarray, np.ndarray]] = {}

    def sp(b: float):
        key = float(b)
        if key not in sp_cache:
            sp_cache[key] = _bw_shortest_paths(rg, key)
        return sp_cache[key]

    order = []  # topological (leaves first)
    state = [0] * p
    stack = [sink]
    post = []
    while stack:
        i = stack.pop()
        post.append(i)
        stack.extend(tree.children(i))
    order = list(reversed(post))

    C = np.zeros((p, n), np.float64)
    choice: dict[tuple[int, int], dict[int, int]] = {}  # (i, v) -> {child: u}
    for i in order:
        ci = np.where(rg.cap >= tree.creq[i] - 1e-9, 0.0, BIGF)
        if i in tree.pinned:
            pin = np.full(n, BIGF)
            pin[tree.pinned[i]] = 0.0
            ci = np.maximum(ci, pin)
        for c in tree.children(i):
            dist, pred = sp(float(tree.breq[c]))
            # add min over u of C[c][u] + dist[u, v] for each v
            tot = C[c][:, None] + dist  # (u, v)
            ci = ci + tot.min(axis=0)
            arg = tot.argmin(axis=0)
            for v in range(n):
                choice.setdefault((i, v), {})[c] = int(arg[v])
        C[i] = np.minimum(ci, BIGF)

    v_sink = tree.pinned[sink]
    if C[sink][v_sink] >= BIGF / 2:
        return None
    # Reconstruct.
    assign = np.full(p, -1, np.int64)
    routes: dict[int, tuple[int, ...]] = {}
    stack = [(sink, v_sink)]
    total = 0.0
    while stack:
        i, v = stack.pop()
        assign[i] = v
        for c in tree.children(i):
            u = choice.get((i, v), {}).get(c)
            if u is None:
                return None
            dist, pred = sp(float(tree.breq[c]))
            r = _extract_route(pred, u, v)
            if r is None:
                return None
            routes[c] = r
            total += float(dist[u, v])
            stack.append((c, u))
    # Cumulative capacity validation + one repair pass.
    valid = _capacity_ok(rg, tree, assign)
    if not valid:
        assign, valid = _repair(rg, tree, assign, C)
        if valid:  # recompute routes/cost after repair
            return treemap_fixed(rg, tree, assign)
    return TreeMapping(tuple(int(a) for a in assign), total, bool(valid), routes)


def _capacity_ok(rg, tree, assign) -> bool:
    used = np.zeros(rg.n)
    for i, v in enumerate(assign):
        used[v] += tree.creq[i]
    return bool(np.all(used <= rg.cap + 1e-6))


def _repair(rg, tree, assign, C):
    """Move nodes off over-subscribed resources to their next-best entries."""
    assign = assign.copy()
    for _ in range(tree.p):
        used = np.zeros(rg.n)
        for i, v in enumerate(assign):
            used[v] += tree.creq[i]
        over = np.nonzero(used > rg.cap + 1e-6)[0]
        if len(over) == 0:
            return assign, True
        v = int(over[0])
        movable = [
            i for i in range(tree.p)
            if assign[i] == v and i not in tree.pinned and tree.creq[i] > 0
        ]
        if not movable:
            return assign, False
        i = max(movable, key=lambda i: tree.creq[i])
        costs = C[i].copy()
        costs[v] = BIGF
        headroom = rg.cap - used + (0)
        costs[headroom < tree.creq[i] - 1e-9] = BIGF
        nv = int(np.argmin(costs))
        if costs[nv] >= BIGF / 2:
            return assign, False
        assign[i] = nv
    return assign, False


def treemap_fixed(rg: ResourceGraph, tree: DataflowTree, assign) -> Optional[TreeMapping]:
    """Cost/route evaluation of a fixed assignment (used after repair)."""
    total = 0.0
    routes = {}
    for c in range(tree.p):
        par = int(tree.parent[c])
        if par < 0:
            continue
        dist, pred = _bw_shortest_paths(rg, float(tree.breq[c]))
        u, v = int(assign[c]), int(assign[par])
        r = _extract_route(pred, u, v)
        if r is None or not np.isfinite(dist[u, v]):
            return None
        routes[c] = r
        total += float(dist[u, v])
    return TreeMapping(tuple(int(a) for a in assign), total, _capacity_ok(rg, tree, assign), routes)
