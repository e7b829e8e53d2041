"""Event-driven simulator of the paper's distributed algorithm (Alg. 4).

Numpy copy of ``repro/core/simulator.py``: no tensor code; it imports only
the port's own modules.

Faithful asynchronous message-passing: each resource node knows only its
immediate neighborhood (its capacity, bandwidth/latency of incident links).
A mapping request is injected at the pinned source node; partial maps travel
as messages whose delivery delay is the link latency; a node receiving a map
runs ``ProcessMap`` — extend locally with 0..p-j-1 computations, forward
along links satisfying the next dataflow edge's bandwidth requirement,
avoiding nodes already in the carried route (Alg. 4 line 12).  Messages
carry the partial mapping itself (Alg. 4 line 1).

Pruning policies reproduce the paper's §3.4 heuristics:

- ``exact``        — no pruning, per-node dedup of identical states.
- ``leastcost``    — keep/forward only new per-(node, prefix-length) minima;
                     higher-cost maps that *arrive first* are still processed
                     (the asynchrony caveat of §3.4.1).
- ``annealed``     — additionally accept a non-minimal map with prob
                     exp(-delta/T), T decaying with virtual time (§3.4.2).
- ``random_k``     — forward to a random subset of k feasible neighbors
                     (§3.4.3).

Instrumented: messages sent/processed/pruned, per-node set sizes, virtual
completion time — these feed ``benchmarks/bench_messages.py`` (the paper's
~100x message-reduction and RandomNeighbor quality claims).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional

import numpy as np

from .graph import DataflowPath, Mapping, ResourceGraph
from .problem import EPS_BW, EPS_COST, make_cap_ok


@dataclasses.dataclass
class SimStats:
    messages_sent: int = 0
    messages_processed: int = 0
    messages_pruned: int = 0
    max_set_size: int = 0  # max total stored partial maps across all nodes
    virtual_time: float = 0.0
    completed_at: Optional[float] = None  # virtual time of first feasible map


@dataclasses.dataclass
class SimConfig:
    policy: str = "leastcost"  # exact | leastcost | annealed | random_k
    stop: str = "quiesce"  # "first" (paper's forced termination) | "quiesce"
    k: int = 1  # random_k fan-out
    t0: float = 5.0  # annealed initial temperature
    tau: float = 50.0  # annealed time constant (virtual-time units)
    seed: int = 0
    max_messages: int = 5_000_000


def simulate(
    rg: ResourceGraph, df: DataflowPath, cfg: SimConfig = SimConfig()
) -> tuple[Optional[Mapping], SimStats]:
    p, n = df.p, rg.n
    src, dst = df.src, df.dst
    rng = np.random.default_rng(cfg.seed)
    stats = SimStats()
    cap_ok = make_cap_ok(rg, df)  # place nodes j..k-1 on v

    neighbors = {u: rg.neighbors(u) for u in range(n)}

    # Per-node state (strictly local knowledge).
    seen: list[set] = [set() for _ in range(n)]  # exact/random_k dedup
    best_cost: list[list[float]] = [[np.inf] * (p + 1) for _ in range(n)]
    stored: list[int] = [0] * n

    best: Optional[Mapping] = None
    counter = itertools.count()
    queue: list = []  # (time, tiebreak, target, assign, route, cost)

    def send(t: float, u: int, v: int, assign: tuple, route: tuple, cost: float):
        stats.messages_sent += 1
        if stats.messages_sent > cfg.max_messages:
            raise MemoryError(f"message explosion (> {cfg.max_messages})")
        heapq.heappush(
            queue, (t + float(rg.lat[u, v]), next(counter), v, assign, route, cost)
        )

    def accept(u: int, assign: tuple, route: tuple, cost: float, t: float) -> bool:
        """Per-policy decision to process (and store) an arriving map."""
        j = len(assign)
        if cfg.policy in ("exact", "random_k"):
            key = (assign, route)
            if key in seen[u]:
                return False
            seen[u].add(key)
            stored[u] += 1
            return True
        if cost < best_cost[u][j] - EPS_COST:
            best_cost[u][j] = cost
            stored[u] += 1
            return True
        if cfg.policy == "annealed":
            T = cfg.t0 * np.exp(-t / cfg.tau)
            if T > 1e-9 and rng.random() < np.exp(-(cost - best_cost[u][j]) / T):
                stored[u] += 1
                return True
        return False

    def process(u: int, assign: tuple, route: tuple, cost: float, t: float):
        """Paper Alg. 4 (ProcessMap)."""
        nonlocal best
        stats.messages_processed += 1
        j = len(assign)
        if u == dst:
            # Alg. 4 lines 3-7: place all remaining computations on t.
            if cap_ok(j, p, u):
                m = Mapping(assign + (u,) * (p - j), route, cost)
                if best is None or cost < best.cost:
                    best = m
                    if stats.completed_at is None:
                        stats.completed_at = t
            return
        # Alg. 4 lines 9-19.
        for x in range(0, p - j):
            if not cap_ok(j, j + x, u):
                break  # monotone prefix sums
            k = j + x  # nodes placed after this extension
            if k < 1:
                continue  # the pinned source computation must be placed first
            new_assign = assign + (u,) * x
            outs = [
                v
                for v in neighbors[u]
                if v not in route
                and float(rg.bw[u, v]) + EPS_BW >= float(df.breq[k - 1])
            ]
            if cfg.policy == "random_k" and len(outs) > cfg.k:
                outs = [int(v) for v in rng.choice(outs, size=cfg.k, replace=False)]
            for v in outs:
                # "extend m_x by appending a map of 0 computations on node v"
                send(t, u, v, new_assign, route + (v,), cost + float(rg.lat[u, v]))

    # Request injection: the source processes the empty map (Alg. 4 line 1:
    # the first message carries the requirement definition of the computation).
    if src == dst:
        if cap_ok(0, p, src):
            best = Mapping((src,) * p, (src,), 0.0)
            stats.completed_at = 0.0
        return best, stats
    if accept(src, (), (src,), 0.0, 0.0):
        process(src, (), (src,), 0.0, 0.0)

    while queue:
        t, _, u, assign, route, cost = heapq.heappop(queue)
        stats.virtual_time = t
        stats.max_set_size = max(stats.max_set_size, sum(stored))
        if cfg.stop == "first" and best is not None:
            break  # forced termination broadcast (paper §3.3)
        if accept(u, assign, route, cost, t):
            process(u, assign, route, cost, t)
        else:
            stats.messages_pruned += 1
    return best, stats
