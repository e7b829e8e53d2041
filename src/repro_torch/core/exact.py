"""Paper-faithful exact BCPM algorithm (paper Alg. 1/2/3) + brute-force oracle.

Numpy copy of ``repro/core/exact.py``: no tensor code; it imports only
the port's own modules.

``pathmap_exact`` implements the centralized Bellman-Ford-style relaxation:
every resource node ``u`` maintains sets ``M(u, j)`` of feasible partial maps
of the first ``j`` dataflow nodes onto simple resource paths ``src ⇝ u``.
``|V_R| - 1`` rounds of relaxing every edge enumerate all feasible complete
mappings at ``dst`` (Theorem 3.3).  Exponential in the worst case — this is
the oracle for tests and the baseline for the heuristic benchmarks (the
paper could not run it beyond ~50-node networks; same here).

A partial map is ``(assign, route, cost)`` with ``route`` the simple resource
path (cycle avoidance, paper Alg. 4 line 12) — identical state to the
distributed message payload.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from .graph import DataflowPath, Mapping, ResourceGraph, mapping_cost
from .problem import EPS_BW, EPS_CAP


@dataclasses.dataclass
class ExactStats:
    """Instrumentation for the paper's complexity claims (§3.2, §3.4.1)."""

    max_set_size: int = 0  # max total partial maps alive at once
    total_maps_generated: int = 0
    rounds: int = 0


def _extend_ok(df: DataflowPath, rg: ResourceGraph, j: int, x: int, v: int) -> bool:
    """Paper Alg. 3 (Extend): can dataflow nodes j..j+x-1 be placed on v?"""
    return float(np.sum(df.creq[j : j + x])) <= float(rg.cap[v]) + EPS_CAP


def pathmap_exact(
    rg: ResourceGraph,
    df: DataflowPath,
    *,
    find_first: bool = False,
    max_states: int = 2_000_000,
) -> tuple[Optional[Mapping], ExactStats]:
    """Paper Alg. 1 (Pathmap) + Alg. 2 (Relax) + Alg. 3 (Extend).

    Returns the minimum-latency feasible mapping (or the first found when
    ``find_first``, matching Relax lines 10-12), and set-size stats.
    Raises ``MemoryError`` when the partial-map set exceeds ``max_states``
    (the paper's ">50 nodes infeasible" regime).
    """
    p, n = df.p, rg.n
    src, dst = df.src, df.dst
    # M[u][j] : dict keyed by (assign, route) -> cost (dedup identical states).
    M: list[list[dict]] = [[{} for _ in range(p + 1)] for _ in range(n)]
    stats = ExactStats()
    best: Optional[Mapping] = None

    def consider_complete(assign, route, cost):
        nonlocal best
        m = Mapping(tuple(assign), tuple(route), float(cost))
        if best is None or m.cost < best.cost:
            best = m

    # Initialization (Alg. 1 lines 1-7): prefixes of P_J co-located on src.
    for j in range(1, p + 1):
        if not _extend_ok(df, rg, 0, j, src):
            break  # creq prefix sums are monotone
        if j == p:
            if src == dst:
                consider_complete((src,) * p, (src,), 0.0)
            continue
        M[src][j][((src,) * j, (src,))] = 0.0
        stats.total_maps_generated += 1

    fresh: dict[tuple[int, int], list] = {
        (src, j): list(M[src][j].keys()) for j in range(1, p) if M[src][j]
    }
    edges = list(rg.edges())

    # Outer relaxation loop (Alg. 1 lines 13-17): at most n-1 rounds; we stop
    # early when no new partial map was produced (fixpoint).
    for rnd in range(n - 1):
        stats.rounds = rnd + 1
        produced = {}  # (v, j) -> list of ((assign, route), cost) to merge after the round
        for (u, v) in edges:
            for j in range(1, p):
                keys = fresh.get((u, j))
                if not keys:
                    continue  # Relax line 6: only maps new in the last iteration
                if float(rg.bw[u, v]) + EPS_BW < float(df.breq[j - 1]):
                    continue  # Relax line 5: bandwidth of dataflow edge (j-1, j)
                for (assign, route) in keys:
                    cost = M[u][j][(assign, route)]
                    if v in route:
                        continue  # cycle avoidance (Alg. 4 line 12)
                    ncost = cost + float(rg.lat[u, v])
                    if v == dst:
                        # Relax lines 7-12: place all remaining nodes on t.
                        if _extend_ok(df, rg, j, p - j, v):
                            consider_complete(
                                assign + (v,) * (p - j), route + (v,), ncost
                            )
                            if find_first:
                                return best, stats
                    else:
                        # Relax lines 13-22: all extensions 0..p-j-1 on v.
                        for x in range(0, p - j):
                            if not _extend_ok(df, rg, j, x, v):
                                break  # monotone prefix sums
                            key = (assign + (v,) * x, route + (v,))
                            produced.setdefault((v, j + x), []).append((key, ncost))
        new_fresh: dict[tuple[int, int], list] = {}
        for (v, j), items in produced.items():
            target = M[v][j]
            for key, cost in items:
                if key not in target:
                    stats.total_maps_generated += 1
                    target[key] = cost
                    new_fresh.setdefault((v, j), []).append(key)
        alive = sum(len(d) for row in M for d in row)
        stats.max_set_size = max(stats.max_set_size, alive)
        if alive > max_states:
            raise MemoryError(
                f"exact PathMap state explosion: {alive} partial maps (n={n}, p={p})"
            )
        fresh = new_fresh
        if not fresh:
            break
    return best, stats


def brute_force(
    rg: ResourceGraph, df: DataflowPath, *, max_routes: int = 200_000
) -> Optional[Mapping]:
    """Independent oracle: enumerate simple routes src⇝dst and all contiguous
    placements of the dataflow path along each route.  For tiny instances only.
    """
    import networkx as nx

    G = nx.DiGraph()
    G.add_nodes_from(range(rg.n))
    for u, v in rg.edges():
        G.add_edge(u, v)
    p = df.p
    best: Optional[Mapping] = None
    count = 0
    if df.src == df.dst:
        routes = itertools.chain([[df.src]], nx.all_simple_paths(G, df.src, df.dst))
    else:
        routes = nx.all_simple_paths(G, df.src, df.dst)
    for route in routes:
        count += 1
        if count > max_routes:
            raise MemoryError("brute force route explosion")
        L = len(route)
        if p == 1 and L > 1:
            continue
        # Compositions: c_b >= 0 nodes on route[b] (0 = pass-through hop: a
        # dataflow edge spanning a multi-hop resource path, paper §2.1);
        # c_0 >= 1 and c_{L-1} >= 1 (pinned endpoints).  Cut points are
        # non-decreasing values in [1, p-1].
        for cuts in itertools.combinations_with_replacement(range(1, p), L - 1):
            counts = np.diff((0,) + cuts + (p,))
            assign = []
            ok = True
            for b, c in enumerate(counts):
                if float(np.sum(df.creq[len(assign) : len(assign) + c])) > float(
                    rg.cap[route[b]]
                ) + EPS_CAP:
                    ok = False
                    break
                assign.extend([route[b]] * int(c))
            if not ok:
                continue
            prefix = np.cumsum(counts)
            for b in range(L - 1):
                k = int(prefix[b])  # nodes placed before the hop
                if float(rg.bw[route[b], route[b + 1]]) + EPS_BW < float(df.breq[k - 1]):
                    ok = False
                    break
            if not ok:
                continue
            cost = mapping_cost(rg, route)
            if best is None or cost < best.cost:
                best = Mapping(tuple(assign), tuple(route), cost)
    return best
