"""Centralized variants of the paper's §3.4 heuristics.

Numpy copy of ``repro/core/heuristics.py``: no tensor code; it imports only
the port's own modules.

``anneal_python``  — AnnealedLeastCostMap (§3.4.2): per (node, prefix) keep
the incumbent minimum plus, with probability exp(-delta/T(round)), bounded
extra non-minimal maps, trading message/set complexity for solution quality.

``random_k_python`` — RandomNeighbor (§3.4.3): LeastCostMap pruning, but each
relaxed map is only offered to a random subset of k neighbors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import DataflowPath, Mapping, ResourceGraph
from .leastcost import HeuristicStats
from .problem import EPS_BW, EPS_COST, make_cap_ok


def _run(
    rg: ResourceGraph,
    df: DataflowPath,
    *,
    policy: str,
    k: int = 1,
    t0: float = 5.0,
    decay: float = 0.7,
    max_keep: int = 4,
    seed: int = 0,
) -> tuple[Optional[Mapping], HeuristicStats]:
    p, n = df.p, rg.n
    src, dst = df.src, df.dst
    rng = np.random.default_rng(seed)
    stats = HeuristicStats()
    cap_ok = make_cap_ok(rg, df)

    # M[u][j] = list of (cost, assign, route); index 0 is the incumbent min.
    M: list[list[list]] = [[[] for _ in range(p + 1)] for _ in range(n)]
    best: Optional[Mapping] = None

    for j in range(1, p):
        if not cap_ok(0, j, src):
            break
        M[src][j] = [(0.0, (src,) * j, (src,))]
    if src == dst and cap_ok(0, p, src):
        best = Mapping((src,) * p, (src,), 0.0)

    out_nbrs = {u: rg.neighbors(u) for u in range(n)}
    fresh = {(src, j) for j in range(1, p) if M[src][j]}
    for rnd in range(n - 1):
        stats.rounds = rnd + 1
        T = t0 * (decay ** rnd)
        new_fresh: set = set()
        for (u, j) in sorted(fresh):
            for (cost, assign, route) in list(M[u][j]):
                nbrs = out_nbrs[u]
                if policy == "random_k" and len(nbrs) > k:
                    nbrs = [int(v) for v in rng.choice(nbrs, size=k, replace=False)]
                for v in nbrs:
                    if v in route:
                        continue
                    if float(rg.bw[u, v]) + EPS_BW < float(df.breq[j - 1]):
                        continue
                    ncost = cost + float(rg.lat[u, v])
                    if v == dst:
                        if cap_ok(j, p, v):
                            m = Mapping(assign + (v,) * (p - j), route + (v,), ncost)
                            if best is None or m.cost < best.cost:
                                best = m
                        continue
                    for x in range(0, p - j):
                        if not cap_ok(j, j + x, v):
                            break
                        jj = j + x
                        entry = (ncost, assign + (v,) * x, route + (v,))
                        cur = M[v][jj]
                        if not cur or ncost < cur[0][0] - EPS_COST:
                            cur.insert(0, entry)
                            del cur[max_keep:]
                            stats.total_maps_generated += 1
                            new_fresh.add((v, jj))
                        elif policy == "annealed" and T > 1e-9:
                            delta = ncost - cur[0][0]
                            if rng.random() < np.exp(-delta / T) and len(cur) < max_keep:
                                cur.append(entry)
                                stats.total_maps_generated += 1
                                new_fresh.add((v, jj))
        stats.max_set_size = max(
            stats.max_set_size, sum(len(c) for row in M for c in row)
        )
        fresh = new_fresh
        if not fresh:
            break
    return best, stats


def anneal_python(rg, df, *, t0=5.0, decay=0.7, max_keep=4, seed=0):
    return _run(rg, df, policy="annealed", t0=t0, decay=decay, max_keep=max_keep, seed=seed)


def random_k_python(rg, df, *, k=1, seed=0):
    # LeastCostMap-style storage (one map per (node, prefix)), random fan-out.
    return _run(rg, df, policy="random_k", k=k, seed=seed, max_keep=1)
