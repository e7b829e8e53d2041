"""Decentralized regional control plane: sharded queues, gossiped shares,
compacted region-local solves, and bounded two-phase commit for
region-spanning dataflows decomposed over multi-hop region chains.

Port of ``repro/service/regions.py``: ``device=`` reaches every
per-region plane's placer in place of ``use_kernel``.

The paper argues mapping should be computable *without* aggregating global
network state at one node.  The centralized :class:`ControlPlane` holds a
global view; this module shards it.  ``ControlPlane(rg, regions=R)``
builds a :class:`RegionalControlPlane`:

- the network is partitioned into R balanced, BFS-grown regions
  (:func:`partition_regions`, or a caller-pinned ``region_of``
  assignment); each region owns a full centralized :class:`ControlPlane`
  over its **compacted** subgraph: a
  :class:`~repro_torch.core.compact.CompactedView` remaps the region's nodes
  onto the contiguous local id space ``[0, n_r)``, so every piece of
  regional state — residual arrays, liveness masks, tickets, DP state,
  kernel tiles — is sized ``n_r``, not the global ``n``.  R regions are
  R x smaller solves, not just R x smaller mailboxes.  Composition makes
  ``R = 1`` the *bit-identical* degenerate case: the identity view
  translates by returning its inputs unchanged, so one region runs the
  centralized plane's exact objects.
- regions never read each other's live accounting.  A
  :class:`~repro_torch.service.gossip.GossipBus` spreads versioned per-tenant
  committed-share / residual estimates on a configurable fanout & period
  (``R * fanout`` messages per round, independent of node count) and each
  region's fair-share drain runs against *local truth + gossiped
  estimates* (``ControlPlane.pump(extra_committed=...)``).  Stale
  estimates can only skew drain order — admission always validates
  against the region's own residual, so capacity is never over-committed
  (property-tested with maximally stale gossip in ``tests/test_regions``).
- a request whose endpoints live in different regions is decomposed over
  a **region chain**: the fewest-hop path from the source region to the
  destination region over the quotient graph of regions (edges = alive
  cut links), possibly through intermediate regions.  The dataflow is cut
  at one edge per hop (:func:`split_dataflow_chain`) into one
  gateway-pinned segment per region on the chain; the broker tries at
  most ``max_cut_attempts`` (splits, cut-edges) candidates — splits
  ordered by compute balance across the segments, cuts by latency — and
  places each candidate with ONE bounded two-phase commit: reserve every
  segment in its region (the single blocker may escalate to budgeted
  class preemption, only as the candidate's *last* reservation), reserve
  every cut's bandwidth, then commit — or roll every reservation back.
  A candidate costs at most ``2 * len(chain) + 2`` messages; 2PC traffic
  is counted in ``Stats.twopc_messages``, gossip in
  ``Stats.gossip_messages``.

The broker is the only holder of global node ids: regional tickets live
in their region's local id space, and every spanning reservation is
recorded as a :class:`SpanPart` — ``(region, tid, local segment,
bijection version)`` — so a handle minted under a stale view generation
is detectable.  Cross-region (cut) links belong to no region; their
bandwidth is the broker's own conservation ledger.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
from typing import Optional

import numpy as np

from ..core import engine
from ..core.compact import CompactedView
from ..core.graph import INF, DataflowPath, ResourceGraph
from ..core.online import Ticket
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .controlplane import ControlPlane, Request, TenantState
from .gossip import GossipBus
from .policy import FairSharePolicy, TenantConfig, fairness_summary

_EPS = 1e-9


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------


def partition_regions(rg: ResourceGraph, R: int, *, seed: int = 0) -> np.ndarray:
    """Balanced BFS partition: node -> region id in ``[0, R)``.

    R seed nodes are drawn (seeded rng), then regions grow breadth-first
    one node per sweep — sizes differ by at most one.  A region whose
    frontier is exhausted (disconnected remainder) grabs the
    lowest-indexed unassigned node, so every node is always assigned.
    Deterministic for a fixed (graph, R, seed).  Every region is
    guaranteed non-empty (R is clamped to ``n``; each region owns its
    seed node) — an empty region raises instead of failing downstream in
    view construction.
    """
    n = rg.n
    if n == 0:
        raise ValueError("cannot partition an empty resource graph (n=0)")
    R = max(1, min(int(R), n))
    if R == 1:
        return np.zeros(n, np.int64)
    rng = np.random.default_rng(seed)
    assign = np.full(n, -1, np.int64)
    seeds = np.sort(rng.choice(n, size=R, replace=False))
    frontiers: list[collections.deque] = []
    for r, s in enumerate(seeds):
        assign[s] = r
        frontiers.append(collections.deque(rg.neighbors(int(s))))
    unassigned = n - R
    while unassigned:
        for r in range(R):
            node = None
            while frontiers[r]:
                cand = int(frontiers[r].popleft())
                if assign[cand] < 0:
                    node = cand
                    break
            if node is None:
                rem = np.nonzero(assign < 0)[0]
                if rem.size == 0:
                    break
                node = int(rem[0])
            assign[node] = r
            frontiers[r].extend(rg.neighbors(node))
            unassigned -= 1
            if not unassigned:
                break
    counts = np.bincount(assign, minlength=R)
    if counts.min() == 0:  # unreachable with seeded growth; fail loudly
        raise ValueError(
            f"partition produced an empty region (n={n}, R={R}, "
            f"sizes={counts.tolist()}); use fewer regions"
        )
    return assign


def validate_region_of(rg: ResourceGraph, region_of) -> np.ndarray:
    """Validate a caller-supplied node -> region assignment: one id per
    node, contiguous region ids ``0..R-1``, every region non-empty.
    Raises a clear ``ValueError`` instead of letting view construction
    fail downstream."""
    assign = np.asarray(region_of, np.int64)
    if assign.shape != (rg.n,):
        raise ValueError(
            f"region_of must map every node: expected shape ({rg.n},), "
            f"got {assign.shape}"
        )
    if rg.n == 0:
        raise ValueError("cannot shard an empty resource graph (n=0)")
    if assign.min() < 0:
        raise ValueError("region_of contains negative region ids")
    R = int(assign.max()) + 1
    counts = np.bincount(assign, minlength=R)
    empty = np.nonzero(counts == 0)[0]
    if empty.size:
        raise ValueError(
            f"region_of leaves region(s) {empty.tolist()} empty "
            f"(region ids must be contiguous 0..{R - 1} and every region "
            "must own at least one node); merge or renumber the regions"
        )
    return assign


def region_subgraph(rg: ResourceGraph, assign: np.ndarray, r: int) -> ResourceGraph:
    """The subgraph region ``r`` owns, in the *global* id space:
    out-of-region nodes keep their ids but lose all capacity and links.

    Superseded on the control-plane path by
    :class:`~repro_torch.core.compact.CompactedView` (which drops foreign rows
    entirely instead of masking them, so solves run at ``n_r``); kept as
    the masking reference the compacted substrate is equivalence-tested
    against."""
    mine = assign == r
    pair = mine[:, None] & mine[None, :]
    cap = np.where(mine, rg.cap, 0.0).astype(np.float32)
    bw = np.where(pair, rg.bw, 0.0).astype(np.float32)
    lat = np.where(pair, rg.lat, INF).astype(np.float32)
    np.fill_diagonal(lat, 0.0)
    return ResourceGraph(cap, bw, lat)


def cut_edges(rg: ResourceGraph, assign: np.ndarray) -> list[tuple[int, int]]:
    """Directed physical links crossing a region boundary."""
    return [
        (u, v) for (u, v) in rg.edges() if assign[u] != assign[v]
    ]


def split_dataflow_chain(
    df: DataflowPath,
    splits,
    gates,
) -> list[DataflowPath]:
    """Decompose ``df`` along a region chain: cut at dataflow edges
    ``splits[0] <= ... <= splits[m-1]``, hop ``i`` crossing the cut link
    ``gates[i] = (u_i, v_i)``.  Segment ``i`` holds dataflow nodes
    ``splits[i-1]+1 .. splits[i]`` (sentinels -1 / p-1), pinned from the
    inbound head gateway ``v_{i-1}`` (``df.src`` for the first) to the
    outbound tail gateway ``u_i`` (``df.dst`` for the last); cut ``i``
    carries ``breq[splits[i]]``.

    Segments are pinned to the gateways through **ghost endpoints**: a
    zero-compute dataflow node at the in/out gateway, joined to the
    segment's real boundary node by an edge carrying the cut dataflow
    edge's bandwidth — so the in-region transport from wherever the
    boundary node is placed to the gateway is reserved honestly, and no
    dataflow node is forced to sit *at* a gateway.  Equal consecutive
    splits make the region between them a pure **transit** region: no
    real dataflow node, just the two ghost gateway endpoints and the one
    carried edge (a single ghost node when both gateways coincide).
    Transit is what admits a short dataflow between non-adjacent regions
    (e.g. p = 2 across a 3-region chain).  Endpoints stay in global ids —
    the broker compacts each segment into its region's local space at
    reserve time.
    """
    p = df.p
    m = len(splits)
    bounds = [-1] + list(splits) + [p - 1]
    segs = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i] + 1, bounds[i + 1]
        if lo > hi:  # transit: carries dataflow edge splits[i-1] only
            u, v = int(gates[i - 1][1]), int(gates[i][0])
            carried = float(df.breq[splits[i - 1]])
            if u == v:
                segs.append(DataflowPath(
                    np.zeros(1, np.float32), np.zeros(0, np.float32), u, v))
            else:
                segs.append(DataflowPath(
                    np.zeros(2, np.float32),
                    np.asarray([carried], np.float32), u, v))
            continue
        creq = list(np.asarray(df.creq[lo:hi + 1], np.float64))
        breq = list(np.asarray(df.breq[lo:hi], np.float64))
        if i == 0:
            src = int(df.src)
        else:  # ghost at the inbound head gateway, carrying the cut edge
            src = int(gates[i - 1][1])
            creq = [0.0] + creq
            breq = [float(df.breq[splits[i - 1]])] + breq
        if i == m:
            dst = int(df.dst)
        else:  # ghost at the outbound tail gateway, carrying the cut edge
            dst = int(gates[i][0])
            creq = creq + [0.0]
            breq = breq + [float(df.breq[splits[i]])]
        segs.append(DataflowPath(
            np.asarray(creq, np.float32), np.asarray(breq, np.float32),
            src, dst,
        ))
    return segs


def split_dataflow(
    df: DataflowPath, s: int, u: int, v: int
) -> tuple[DataflowPath, DataflowPath]:
    """Single-cut decomposition at dataflow edge ``s`` across the cut
    link (u, v) — the chain of length 2 (see
    :func:`split_dataflow_chain`)."""
    a, b = split_dataflow_chain(df, [s], [(u, v)])
    return a, b


# ---------------------------------------------------------------------------
# spanning placements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpanPart:
    """One reserved segment of a spanning placement: the owning region,
    the region-local ticket id, the *local-id* segment object the
    region's ticket holds (identity-checked by the invariants), and the
    region view's bijection version at reserve time — a part minted under
    an older generation than the view's current one is a churn survivor,
    and one minted under a newer-than-current version is a bug."""

    region: int
    tid: int
    seg: DataflowPath
    version: int


@dataclasses.dataclass(eq=False)
class SpanningTicket:
    """Composite handle for a cross-region placement: one reserved
    segment per region on the chain plus one cut-bandwidth reservation
    per hop.  ``parts`` hold (region, tid) pairs, not Ticket objects —
    region defrag re-keys tickets under stable tids, so the handle
    survives re-optimization."""

    rid: int
    req: Request
    parts: list[SpanPart]  # ordered along the region chain
    cuts: list[tuple[int, int]]  # global gateway pairs, one per hop
    cut_bws: list[float]
    splits: list[int]  # dataflow edge indices carried by the cuts

    @property
    def tenant(self) -> str:
        return self.req.tenant

    @property
    def klass(self) -> int:
        return self.req.klass

    @property
    def df(self) -> DataflowPath:
        return self.req.df

    @property
    def chain(self) -> list[int]:
        """The ordered region chain this placement spans."""
        return [p.region for p in self.parts]

    # single-cut convenience (the chain-of-2 common case)
    @property
    def cut(self) -> tuple[int, int]:
        return self.cuts[0]

    @property
    def cut_bw(self) -> float:
        return self.cut_bws[0]

    @property
    def split(self) -> int:
        return self.splits[0]


class ChainBroker:
    """Cut-edge ledger + quotient-graph chain selection, shared by every
    plane that brokers spanning placements over child partitions: the flat
    :class:`RegionalControlPlane` over its regions, and the
    :class:`~repro_torch.service.hierarchy.HierarchicalControlPlane` over its
    child planes.

    Subclasses provide ``base`` (the network in THIS plane's id space),
    ``region_of`` (node -> child index), ``node_up`` and
    ``max_cut_attempts`` before calling :meth:`_init_cut_ledger`.  The
    broker's resident state is deliberately small: the cut ledger holds
    only the *boundary* gateway ids plus the quotient graph over direct
    children — never the full membership of any child."""

    base: ResourceGraph
    region_of: np.ndarray
    node_up: np.ndarray
    max_cut_attempts: int
    chain_k: int
    congestion_weight: float
    max_cum_attempts: int

    def _init_cut_ledger(self) -> None:
        """Build the cut-edge bandwidth ledger: cut links belong to no
        child (they are outside every compacted submatrix), so this ledger
        is their only accounting, reserved/released by the plane's 2PC."""
        self.cut_base: dict[tuple[int, int], float] = {}
        self.cut_residual: dict[tuple[int, int], float] = {}
        self.cut_link_up: dict[tuple[int, int], bool] = {}
        self._cut_by_pair: dict[tuple[int, int], list[tuple[int, int]]] = {}
        self._gateways_of: dict[int, list[int]] = {}
        for (u, v) in cut_edges(self.base, self.region_of):
            self.cut_base[(u, v)] = float(self.base.bw[u, v])
            self.cut_residual[(u, v)] = float(self.base.bw[u, v])
            self.cut_link_up[(u, v)] = True
            self._cut_by_pair.setdefault(
                (int(self.region_of[u]), int(self.region_of[v])), []
            ).append((u, v))
            gws = self._gateways_of.setdefault(int(self.region_of[u]), [])
            if u not in gws:
                gws.append(u)
        for gws in self._gateways_of.values():
            gws.sort()

    def _cut_alive(self, u: int, v: int) -> bool:
        return (
            self.cut_link_up.get((u, v), False)
            and bool(self.node_up[u]) and bool(self.node_up[v])
        )

    def _quotient_adjacency(self) -> dict[int, dict[int, float]]:
        """The quotient graph of children under the currently-alive cut
        edges: ``adj[r1][r2]`` = min latency among alive (r1 -> r2) cuts."""
        adj: dict[int, dict[int, float]] = {}
        for (r1, r2), edges in self._cut_by_pair.items():
            lats = [
                float(self.base.lat[e]) for e in edges if self._cut_alive(*e)
            ]
            if lats:
                adj.setdefault(r1, {})[r2] = min(lats)
        return adj

    def _region_chain(self, ra: int, rb: int) -> Optional[list[int]]:
        """Fewest-hop child chain ``ra -> ... -> rb`` over the quotient
        graph (ties by summed min cut latency, then child ids — fully
        deterministic).  None when the quotient graph is partitioned."""
        adj = self._quotient_adjacency()
        best: dict[int, tuple[int, float]] = {ra: (0, 0.0)}
        heap: list[tuple[int, float, tuple[int, ...]]] = [(0, 0.0, (ra,))]
        while heap:
            hops, lat, path = heapq.heappop(heap)
            r = path[-1]
            if r == rb:
                return list(path)
            if (hops, lat) > best.get(r, (hops, lat)):
                continue  # stale heap entry
            for nb in sorted(adj.get(r, {})):
                if nb in path:
                    continue
                cand = (hops + 1, lat + adj[r][nb])
                if nb not in best or cand < best[nb]:
                    best[nb] = cand
                    heapq.heappush(heap, (*cand, path + (nb,)))
        return None

    # -- congestion-aware k-shortest chains -----------------------------------

    def _edge_congestion(self, e: tuple[int, int],
                         occ_view: dict[int, float]) -> float:
        """Congestion estimate for one cut edge: this broker's own ledger
        utilization of the cut, plus the gossiped occupancy of both
        gateway endpoints.  The ledger term is exact (2PC-maintained);
        the occupancy terms may be arbitrarily stale — they only ever
        rank chains, never admit over capacity."""
        base = self.cut_base[e]
        util = 1.0 - self.cut_residual[e] / base if base > 0 else 0.0
        u, v = e
        return max(0.0, util) + occ_view.get(u, 0.0) + occ_view.get(v, 0.0)

    def _edge_cost(self, e: tuple[int, int],
                   occ_view: dict[int, float]) -> float:
        """Load-aware chain metric: ``lat * (1 + w * congestion)``.  With
        ``congestion_weight == 0`` this degenerates to pure latency."""
        lat = float(self.base.lat[e])
        w = self.congestion_weight
        if w <= 0.0:
            return lat
        return lat * (1.0 + w * self._edge_congestion(e, occ_view))

    def _cost_adjacency(
        self, occ_view: dict[int, float]
    ) -> dict[int, dict[int, float]]:
        """Quotient graph under the load-aware metric: ``adj[r1][r2]`` =
        min :meth:`_edge_cost` among alive (r1 -> r2) cuts."""
        adj: dict[int, dict[int, float]] = {}
        for (r1, r2), edges in self._cut_by_pair.items():
            costs = [
                self._edge_cost(e, occ_view)
                for e in edges if self._cut_alive(*e)
            ]
            if costs:
                adj.setdefault(r1, {})[r2] = min(costs)
        return adj

    @staticmethod
    def _dijkstra_chain(adj, ra: int, rb: int, banned_nodes=(),
                        banned_edges=()) -> Optional[tuple[float, list[int]]]:
        """Deterministic least-cost loopless path ``ra -> rb`` over a cost
        adjacency (ties by hops then child ids).  ``banned_nodes`` /
        ``banned_edges`` support Yen spur searches."""
        banned_nodes = set(banned_nodes)
        banned_edges = set(banned_edges)
        best: dict[int, tuple[float, int]] = {ra: (0.0, 0)}
        heap: list[tuple[float, int, tuple[int, ...]]] = [(0.0, 0, (ra,))]
        while heap:
            cost, hops, path = heapq.heappop(heap)
            r = path[-1]
            if r == rb:
                return cost, list(path)
            if (cost, hops) > best.get(r, (cost, hops)):
                continue  # stale heap entry
            for nb in sorted(adj.get(r, {})):
                if nb in path or nb in banned_nodes or (r, nb) in banned_edges:
                    continue
                cand = (cost + adj[r][nb], hops + 1)
                if nb not in best or cand < best[nb]:
                    best[nb] = cand
                    heapq.heappush(heap, (*cand, path + (nb,)))
        return None

    def _region_chains(self, ra: int, rb: int,
                       occ_view: dict[int, float]) -> list[list[int]]:
        """Up to ``chain_k`` loopless region chains ``ra -> rb`` by Yen's
        algorithm under the load-aware edge cost, cheapest first.  Chains
        through hot gateways cost more, so a saturated fewest-hop chain
        sorts behind a longer cold bypass *before* any 2PC probes it.
        ``chain_k == 1`` planes never call this — they take the legacy
        fewest-hop :meth:`_region_chain` path unchanged."""
        adj = self._cost_adjacency(occ_view)
        first = self._dijkstra_chain(adj, ra, rb)
        if first is None:
            return []
        found: list[tuple[float, list[int]]] = [first]
        seen = {tuple(first[1])}
        frontier: list[tuple[float, int, tuple[int, ...]]] = []
        while len(found) < self.chain_k:
            _, prev = found[-1]
            for i in range(len(prev) - 1):
                root = prev[:i + 1]
                spur_bans = {
                    (p[i], p[i + 1]) for _, p in found
                    if len(p) > i + 1 and p[:i + 1] == root
                }
                spur = self._dijkstra_chain(
                    adj, root[-1], rb, banned_nodes=root[:-1],
                    banned_edges=spur_bans,
                )
                if spur is None:
                    continue
                scost, spath = spur
                rcost = sum(adj[root[j]][root[j + 1]] for j in range(i))
                path = tuple(root[:-1] + spath)
                if path not in seen:
                    seen.add(path)
                    heapq.heappush(
                        frontier, (rcost + scost, len(path) - 1, path))
            if not frontier:
                break
            cost, _, path = heapq.heappop(frontier)
            found.append((cost, list(path)))
        return [p for _, p in found]

    def _race_candidates(self, df: DataflowPath, chains: list[list[int]],
                         occ_view: dict[int, float]) -> list:
        """Round-robin interleave of ``(chain, splits, gates)`` candidates
        across the k chains, cheapest chain first, with gates per hop
        ordered by the same load-aware cost.  The total is capped at
        ``max_cut_attempts`` — racing chains never widens the 2PC probe
        budget beyond the single-chain broker's."""
        budget = self.max_cut_attempts

        def key(e):
            return (self._edge_cost(e, occ_view), float(self.base.lat[e]), e)

        per = [
            collections.deque(
                self._candidate_chains(df, ch, limit=budget, edge_key=key))
            for ch in chains
        ]
        out = []
        while len(out) < budget and any(per):
            for ch, dq in zip(chains, per):
                if dq:
                    splits, gates = dq.popleft()
                    out.append((ch, splits, gates))
                    if len(out) >= budget:
                        break
        return out

    def _requeue_or_livelock_drop(self, st: SpanningTicket) -> None:
        """Requeue a displaced spanning request at its home child — or
        drop it when its *cumulative* attempt budget is spent.  The
        per-episode ``attempts`` resets (displacement is not the
        request's fault) but ``cum_attempts`` never does: a request
        ping-ponging between a saturated chain and displacement meets
        ``max_cum_attempts`` instead of livelocking forever."""
        st.req.attempts = 0
        st.req.cum_attempts += 1
        self.span_stats["max_req_attempts"] = max(
            self.span_stats["max_req_attempts"], st.req.cum_attempts)
        if st.req.cum_attempts >= self.max_cum_attempts:
            self.span_tenants[st.tenant].dropped += 1
            self.span_stats["dropped"] += 1
            self.span_stats["livelock_dropped"] += 1
            if self.tracer.enabled:
                self.tracer.flow_end(
                    st.rid, "drop", outcome="livelock",
                    cum_attempts=st.req.cum_attempts,
                )
            if self.on_drop is not None:
                self.on_drop(st.rid)
            return
        home = int(self.region_of[st.df.src])
        ControlPlane._enqueue(
            self._span_q[home][st.tenant], st.req, front_of_class=True
        )

    def _chain_feasible(self, df: DataflowPath, splits, gates) -> bool:
        """Cut-bandwidth screen for one candidate.  Ghost gateway
        endpoints (see :func:`split_dataflow_chain`) remove every
        structural pinning constraint — whether a segment can actually
        route from its gateway is the child solve's decision."""
        for s, e in zip(splits, gates):
            if self.cut_residual[e] + _EPS < float(df.breq[s]):
                return False
        return True

    def _candidate_chains(self, df: DataflowPath, chain: list[int], *,
                          limit: Optional[int] = None,
                          edge_key=None) -> list:
        """Up to ``limit`` (default ``max_cut_attempts``) (splits,
        cut-edges) candidates for a child chain: split combinations
        (non-decreasing — repeats make transit regions) ordered by compute
        balance across the segments, cut edges per hop by ``edge_key``
        (default link latency; hop order lexicographic)."""
        limit = self.max_cut_attempts if limit is None else max(1, int(limit))
        m = len(chain) - 1
        p = df.p
        edge_lists = []
        for (r1, r2) in zip(chain[:-1], chain[1:]):
            edges = [
                e for e in self._cut_by_pair.get((r1, r2), ())
                if self._cut_alive(*e)
            ]
            if not edges:
                return []
            edges.sort(key=edge_key if edge_key is not None
                       else lambda e: float(self.base.lat[e]))
            edge_lists.append(edges)
        prefix = np.concatenate([[0.0], np.cumsum(df.creq.astype(np.float64))])
        target = float(prefix[-1]) / (m + 1)

        def balance(splits):
            bounds = (-1,) + splits + (p - 1,)
            return sum(
                abs(float(prefix[bounds[i + 1] + 1] - prefix[bounds[i] + 1])
                    - target)
                for i in range(m + 1)
            )

        # bounded search: the exact combination space C(p+m-2, m) is only
        # enumerated while it is small; long dataflows over long chains
        # restrict each cut's candidate positions to a window around its
        # balanced quantile (where balance() is minimized anyway), and a
        # hard islice cap bounds the scoring work outright.  nsmallest
        # then keeps a pool sized so even an adversarial run of
        # infeasible splits cannot starve the max_cut_attempts quota.
        positions = range(p - 1)
        if math.comb(p - 1 + m - 1, m) > 20_000:
            target_pos = {
                min(max(int(np.searchsorted(
                    prefix, float(prefix[-1]) * i / (m + 1))) + d, 0), p - 2)
                for i in range(1, m + 1)
                for d in range(-4, 5)
            }
            positions = sorted(target_pos)
        pool = max(32, 8 * self.max_cut_attempts)
        combos = heapq.nsmallest(
            pool,
            itertools.islice(
                itertools.combinations_with_replacement(positions, m),
                50_000),
            key=lambda s: (balance(s), s),
        )
        out = []
        for splits in combos:
            for gates in itertools.product(*edge_lists):
                if not self._chain_feasible(df, splits, gates):
                    continue
                out.append((splits, gates))
                if len(out) >= limit:
                    return out
        return out


class RegionalControlPlane(ChainBroker):
    """R sharded control planes + gossip + a multi-hop cut-edge 2PC broker.

    Mirrors the centralized :class:`ControlPlane` surface (register_tenant
    / submit / pump / release / fail_* / restore_* / defrag /
    committed_capacity / conservation / fairness_report / engine_stats /
    check_invariants / active_ids), so call sites are plane-agnostic.
    ``pump`` returns a mix of :class:`Ticket` (in-region; their
    mappings/routes are in the owning region's *local* id space —
    resolve the owner with :meth:`owner_region` and lift through
    ``plane.views[r]``) and :class:`SpanningTicket` (cross-region,
    global gateways) handles; ``defrag`` returns one
    :class:`~repro_torch.service.defrag.DefragResult` per region — there is no
    global re-solve, by design.

    ``**solve_cfg`` (including the incremental-fast-path knobs
    ``cache_enabled`` / ``cache_size`` / ``max_correction_supersteps``)
    is forwarded to every per-region placer: each region keeps its own
    :class:`~repro_torch.core.solution_cache.SolutionCache` over *view-local*
    request signatures, invalidated by its own residual version + epoch —
    no cross-region cache coherence is needed because a region only ever
    admits against its own residual truth.
    """

    def __init__(
        self,
        rg: ResourceGraph,
        *,
        regions: Optional[int] = None,
        region_of=None,
        levels: Optional[int] = None,
        branching: Optional[int] = None,
        policy: Optional[FairSharePolicy] = None,
        micro_batch: int = 32,
        max_attempts: int = 8,
        preempt: bool = True,
        preempt_budget: Optional[float] = None,
        pipeline_depth: int = 1,
        method: str = "leastcost_torch",
        device=None,
        fanout: int = 2,
        gossip_period: int = 1,
        max_cut_attempts: int = 4,
        chain_k: int = 2,
        congestion_weight: float = 1.0,
        max_cum_attempts: Optional[int] = None,
        seed: int = 0,
        tracer=None,
        **solve_cfg,
    ):
        self.base = rg
        # nesting kwargs fail fast: this class IS the levels=1 plane — a
        # levels > 1 request must go through ControlPlane(levels=...) /
        # HierarchicalControlPlane, never silently build flat
        if levels is not None and int(levels) != 1:
            raise ValueError(
                f"levels={levels}: RegionalControlPlane is the flat "
                "(levels=1) plane; build a hierarchy with "
                "ControlPlane(rg, levels=...) or HierarchicalControlPlane"
            )
        if branching is not None:
            raise ValueError(
                f"branching={branching} requires a hierarchical plane "
                "(levels >= 2); the flat plane takes regions= or region_of="
            )
        if region_of is not None:
            # caller-pinned partition (e.g. a line-of-regions topology
            # whose canonical assignment the BFS grower would not find);
            # the region count comes from the assignment, and an
            # explicitly contradicting regions= fails fast
            self.region_of = validate_region_of(rg, region_of)
            detected = int(self.region_of.max()) + 1
            if regions is not None and int(regions) != detected:
                raise ValueError(
                    f"regions={regions} contradicts region_of, which "
                    f"defines {detected} regions"
                )
        else:
            self.region_of = partition_regions(
                rg, 2 if regions is None else regions, seed=seed)
        self.R = int(self.region_of.max()) + 1
        self.policy = policy or FairSharePolicy()
        self.micro_batch = int(micro_batch)
        self.max_attempts = int(max_attempts)
        self.preempt = bool(preempt)
        self.preempt_budget = preempt_budget
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.method = method
        self.max_cut_attempts = int(max_cut_attempts)
        # chain_k > 1 races k-shortest region chains under the load-aware
        # cost; chain_k == 1 is the legacy single fewest-hop chain,
        # bit-identical by construction (same code path)
        self.chain_k = max(1, int(chain_k))
        self.congestion_weight = float(congestion_weight)
        # lifetime attempt budget across displacement episodes: a request
        # ping-ponging between admission and displacement resets its
        # per-episode attempts but never this one (livelock backstop)
        self.max_cum_attempts = (
            4 * self.max_attempts if max_cum_attempts is None
            else int(max_cum_attempts)
        )
        # the broker's tracer; each region gets a scoped view sharing the
        # same event buffer ("r{r}/" track prefixes, so region-local rids
        # never collide with broker-level flow ids)
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        # the compacted solve substrate: one global<->local bijection per
        # region; every regional plane below is sized n_r, not n
        self.views = [
            CompactedView.from_assign(rg, self.region_of, r)
            for r in range(self.R)
        ]
        self.regions = [
            ControlPlane(
                rg,
                view=self.views[r],
                policy=self.policy,
                micro_batch=micro_batch,
                max_attempts=max_attempts,
                preempt=preempt,
                preempt_budget=preempt_budget,
                pipeline_depth=pipeline_depth,
                method=method,
                device=device,
                tracer=self.tracer.scoped(f"r{r}"),
                **solve_cfg,
            )
            for r in range(self.R)
        ]
        for r, cp in enumerate(self.regions):
            # an in-region preemption OR churn re-map may displace/drop a
            # spanning segment; the broker must then tear down its sibling
            # reservations (the region plane hands over every foreign tid)
            cp.on_foreign_preempt = (
                lambda tickets, r=r: [
                    self._displace_span_part(r, t) for t in tickets
                ]
            )
            # a region dropping a local request terminates its lifecycle;
            # forget the broker's global-rid bookkeeping for it
            cp.on_drop = (
                lambda lreq, r=r: self._forget_local(r, lreq.rid)
            )
        self.bus = GossipBus(self.R, fanout=fanout, seed=seed + 1)
        self.gossip_period = max(1, int(gossip_period))
        self.node_up = np.ones(rg.n, bool)

        # cut-edge bandwidth ledger: owned by the broker, reserved by 2PC
        # (see ChainBroker._init_cut_ledger)
        self._init_cut_ledger()

        # spanning-request bookkeeping (the broker's ledger)
        self.span_tenants: dict[str, TenantState] = {}
        self._span_q: list[dict[str, collections.deque]] = [
            {} for _ in range(self.R)
        ]
        self._span_active: dict[int, SpanningTicket] = {}
        self._part_of: dict[tuple[int, int], int] = {}  # (region, tid) -> rid
        # global rid space over both local and spanning requests
        self._rid = itertools.count()
        self._local: dict[int, tuple[int, int]] = {}  # rid -> (region, lrid)
        self._grid_of: dict[tuple[int, int], int] = {}  # (region, lrid) -> rid
        self._pumps = 0
        self._twopc_msgs = 0
        # while a churn call (fail_node/fail_link) is reconciling, spanning
        # placements torn down by in-region rescue preemptions collect here
        # so the churn return contract covers them too
        self._churn_collector: Optional[list] = None
        # reservations held by a PARENT plane's 2PC (broker_admit): their
        # lifecycle belongs to the parent — a displacement fires
        # on_broker_displace(rid) instead of requeueing locally, and they
        # are not caller-visible active requests
        self._broker_held: set[int] = set()
        self.on_broker_displace = None  # parent hook: rid -> None
        self.on_drop = None  # parent hook: plane-level rid -> None
        self.span_stats = {
            "attempts": 0, "admitted": 0, "dropped": 0,
            "displaced": 0, "no_cut": 0,
            "multi_hop": 0,  # admitted over chains of >= 3 regions
            "max_chain": 0,  # longest admitted region chain
            "broker_local": 0,  # parent-held single-region reservations
            "rerouted": 0,  # admitted via a non-fewest-hop chain
            "livelock_dropped": 0,  # dropped by the cumulative budget
            "max_req_attempts": 0,  # highest lifetime attempts on one req
        }

    # -- registration / submission ------------------------------------------

    def register_tenant(
        self, name: str, *, weight: float = 1.0,
        budget: Optional[float] = None,
    ) -> TenantConfig:
        if name in self.span_tenants:
            raise ValueError(f"tenant {name!r} already registered")
        cfg = TenantConfig(name, weight=weight, budget=budget)
        for cp in self.regions:
            cp.register_tenant(name, weight=weight, budget=budget)
        self.span_tenants[name] = TenantState(cfg)
        for q in self._span_q:
            q[name] = collections.deque()
        return cfg

    def submit(self, tenant: str, df: DataflowPath, *, klass: int = 0) -> int:
        """Queue a request with its *home* (source) region; a request whose
        endpoints straddle regions queues with the home region's broker
        side instead and is placed by 2PC at pump time.  ``df`` is in
        global ids; in-region requests are compacted into the owning
        region's local id space here, at the broker boundary.  Returns a
        global rid valid across regions."""
        st = self.span_tenants[tenant]  # KeyError for unregistered
        rid = next(self._rid)
        ra = int(self.region_of[df.src])
        rb = int(self.region_of[df.dst])
        if ra == rb:
            lrid = self.regions[ra].submit(
                tenant, self.views[ra].compact_df(df), klass=klass
            )
            self._local[rid] = (ra, lrid)
            self._grid_of[(ra, lrid)] = rid
        else:
            st.submitted += 1
            ControlPlane._enqueue(
                self._span_q[ra][tenant], Request(rid, tenant, df, klass=klass)
            )
            if self.tracer.enabled:
                self.tracer.flow_begin(
                    rid, "submit", tenant=tenant, klass=klass,
                    spanning=True, home=ra,
                )
        return rid

    # -- live accounting -----------------------------------------------------

    def _region_committed(self, r: int) -> dict[str, float]:
        """Region r's exact local per-tenant committed compute, from the
        placer tickets (includes spanning segments reserved there)."""
        held = {t: 0.0 for t in self.span_tenants}
        for tk in self.regions[r].placer.tickets.values():
            if tk.tenant in held:
                held[tk.tenant] += float(np.sum(tk.df.creq))
        return held

    def committed_capacity(self) -> dict[str, float]:
        held = {t: 0.0 for t in self.span_tenants}
        for r in range(self.R):
            for t, c in self._region_committed(r).items():
                held[t] += c
        return held

    def residual_capacity(self) -> float:
        """Summed live residual node capacity across every region (the
        scalar a parent plane publishes as this child's aggregate)."""
        return float(sum(
            np.sum(np.where(cp.placer.node_up, cp.placer.cap, 0.0))
            for cp in self.regions
        ))

    def queued_demand(self) -> dict[str, float]:
        out = {t: 0.0 for t in self.span_tenants}
        for cp in self.regions:
            for t, c in cp.queued_demand().items():
                out[t] += c
        for q in self._span_q:
            for t, dq in q.items():
                out[t] += sum(r.creq_sum for r in dq)
        return out

    def owner_region(self, ticket: Ticket) -> Optional[int]:
        """The region whose placer holds ``ticket`` (by object identity —
        tids are per-region counters and collide across regions).  Use it
        to pick the right ``plane.views[r]`` for lifting an in-region
        handle's local-id mapping/route back to global ids."""
        for r, cp in enumerate(self.regions):
            if cp.placer.tickets.get(ticket.tid) is ticket:
                return r
        return None

    def active_ids(self) -> list[int]:
        """Global rids of active requests across every region + spanning.
        Parent-held broker reservations are excluded — they are segments
        of a composite the parent plane accounts for."""
        out = [
            self._grid_of[(r, lrid)]
            for r, cp in enumerate(self.regions)
            for lrid in cp.active
        ]
        out += [rid for rid in self._span_active if rid not in self._broker_held]
        return sorted(out)

    def ticket_live(self, t) -> bool:
        """Is a handle returned by :meth:`pump` still standing?  (A later
        round — or an enclosing plane's 2PC — may have displaced it.)"""
        if self._span_active.get(getattr(t, "rid", -1)) is t:
            return True
        return any(
            cp.placer.tickets.get(getattr(t, "tid", -1)) is t
            for cp in self.regions
        )

    def conservation(self) -> dict[str, int]:
        """The global ticket ledger: regional ledgers + the broker's
        spanning ledger.  ``ok`` iff every submitted request is in exactly
        one state *summed over regions*."""
        agg = {"submitted": 0, "queued": 0, "in_flight": 0, "active": 0,
               "released": 0, "dropped": 0}
        for cp in self.regions:
            led = cp.conservation()
            for k in agg:
                agg[k] += led[k]
        agg["submitted"] += sum(
            st.submitted for st in self.span_tenants.values())
        agg["queued"] += sum(
            len(dq) for q in self._span_q for dq in q.values())
        agg["active"] += len(self._span_active)
        agg["released"] += sum(
            st.released for st in self.span_tenants.values())
        agg["dropped"] += sum(
            st.dropped for st in self.span_tenants.values())
        agg["ok"] = agg["submitted"] == (
            agg["queued"] + agg["in_flight"] + agg["active"]
            + agg["released"] + agg["dropped"]
        )
        return agg

    # -- gossip --------------------------------------------------------------

    def node_occupancy(self, v: int) -> float:
        """Compute occupancy of global node ``v`` in [0, 1] from its
        owning region's live residual (1.0 when the node is down)."""
        r = int(self.region_of[v])
        cp = self.regions[r]
        lv = int(self.views[r].to_local(v))
        if not (bool(self.node_up[v]) and bool(cp.placer.node_up[lv])):
            return 1.0
        base = float(cp.placer.base.cap[lv])
        if base <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - float(cp.placer.cap[lv]) / base))

    def _gateway_occupancy(self, r: int) -> dict[int, float]:
        """Occupancy of region ``r``'s own gateway nodes (global ids) —
        the per-cut congestion estimate it publishes into gossip."""
        return {u: self.node_occupancy(u)
                for u in self._gateways_of.get(r, ())}

    def _publish(self, r: int) -> None:
        cp = self.regions[r]
        queued = cp.queued_demand()
        for t, dq in self._span_q[r].items():
            queued[t] = queued.get(t, 0.0) + sum(x.creq_sum for x in dq)
        residual = float(
            np.sum(np.where(cp.placer.node_up, cp.placer.cap, 0.0))
        )
        self.bus.publish(r, self._region_committed(r), queued, residual,
                         congestion=self._gateway_occupancy(r))

    # -- admission -----------------------------------------------------------

    def pump(self, *, rounds: int = 1, extra_committed=None) -> list:
        """One decentralized drain round per ``rounds``: publish + gossip
        share estimates, drain every region's queues under
        estimated-global fair shares, then place queued spanning requests
        by bounded 2PC.  Returns the still-live admitted handles
        (:class:`Ticket` for in-region, :class:`SpanningTicket` for
        cross-region).

        ``extra_committed`` is a parent plane's downward-published
        estimate of per-tenant holdings *outside this plane entirely*
        (the tree-gossip downlink); it folds into every region's drain
        the same way gossiped sibling estimates do — advisory for drain
        order, never capacity."""
        admitted: list[Ticket] = []
        spanned: list[SpanningTicket] = []
        for _ in range(int(rounds)):
            self._pumps += 1
            for r in range(self.R):
                self._publish(r)
            if self.R > 1 and self._pumps % self.gossip_period == 0:
                with self.tracer.span("gossip.round", track="gossip",
                                      cat="gossip", round=self._pumps):
                    self.bus.tick()
            for r, cp in enumerate(self.regions):
                extra: dict[str, float] = dict(extra_committed or {})
                if self.R > 1:
                    # gossiped estimate of remote holdings, plus the
                    # broker-reserved spanning segments physically held in
                    # THIS region (they are placer tickets but not local
                    # control-plane requests, so the local accounting
                    # cannot see them)
                    for t, c in self.bus.remote_committed(r).items():
                        extra[t] = extra.get(t, 0.0) + c
                    local_cp = cp.committed_capacity()
                    for t, c in self._region_committed(r).items():
                        diff = c - local_cp.get(t, 0.0)
                        if diff > _EPS:
                            extra[t] = extra.get(t, 0.0) + diff
                admitted += cp.pump(rounds=1, extra_committed=extra or None)
            spanned += self._pump_spanning(extra_committed)
        live = [t for t in admitted if self.ticket_live(t)]
        live += [s for s in spanned if s.rid in self._span_active]
        return live

    def flush(self) -> list[Ticket]:
        """Commit every region's in-flight pipeline windows (barrier); see
        :meth:`ControlPlane.flush`.  The broker's spanning 2PC needs no
        flush of its own — it reserves host-side through ``placer.admit``,
        and an in-flight regional batch that loses capacity to a spanning
        reservation simply re-solves its conflicts at commit."""
        admitted: list[Ticket] = []
        for cp in self.regions:
            admitted += cp.flush()
        return [
            t for t in admitted
            if any(cp.placer.tickets.get(t.tid) is t for cp in self.regions)
        ]

    def warmup(self, *, max_batch: Optional[int] = None, p: int = 5) -> int:
        """Warm each region's kernel batch buckets (region-local ``n_r``
        shapes differ per region, so every placer warms its own)."""
        return max(
            (cp.warmup(max_batch=max_batch, p=p) for cp in self.regions),
            default=0,
        )

    def _pump_spanning(self, extra_committed=None) -> list[SpanningTicket]:
        if self.R <= 1:
            return []
        out: list[SpanningTicket] = []
        cfgs = {t: st.cfg for t, st in self.span_tenants.items()}
        for r in range(self.R):
            queues = self._span_q[r]
            if not any(queues.values()):
                continue
            committed = self._region_committed(r)
            for t, c in self.bus.remote_committed(r).items():
                if t in committed:
                    committed[t] += c
            for t, c in (extra_committed or {}).items():
                if t in committed:
                    committed[t] += c
            picked = self.policy.select(
                cfgs, queues, committed, self.micro_batch
            )
            # pop every selected head BEFORE placing: a 2PC attempt may
            # displace another spanning request to the front of one of
            # these very queues, which must not disturb the drain order
            for req in picked:
                q = queues[req.tenant]
                assert q[0] is req, "policy must select queue heads in order"
                q.popleft()
            for req in picked:
                q = queues[req.tenant]
                st = self._try_place_spanning(req)
                if st is not None:
                    self.span_tenants[req.tenant].admitted += 1
                    if self.tracer.enabled:
                        self.tracer.flow_point(
                            req.rid, "admit", chain=len(st.parts))
                    out.append(st)
                else:
                    req.attempts += 1
                    req.cum_attempts += 1
                    self.span_stats["max_req_attempts"] = max(
                        self.span_stats["max_req_attempts"], req.cum_attempts)
                    exhausted = req.attempts >= self.max_attempts
                    livelocked = req.cum_attempts >= self.max_cum_attempts
                    if exhausted or livelocked:
                        self.span_tenants[req.tenant].dropped += 1
                        self.span_stats["dropped"] += 1
                        if livelocked and not exhausted:
                            self.span_stats["livelock_dropped"] += 1
                        if self.tracer.enabled:
                            self.tracer.flow_end(
                                req.rid, "drop", outcome="dropped",
                                attempts=req.attempts,
                                cum_attempts=req.cum_attempts,
                            )
                        if self.on_drop is not None:
                            self.on_drop(req.rid)
                    else:
                        ControlPlane._enqueue(q, req, front_of_class=True)
        return out

    # -- parent-plane broker interface (hierarchical nesting) ----------------

    def broker_admit(self, tenant: str, df: DataflowPath, *,
                     klass: int = 0) -> Optional[int]:
        """Synchronous, abortable admission used by a PARENT plane's 2PC:
        place ``df`` (in THIS plane's id space) immediately — in one
        region, or spanning this plane's own regions (the recursion that
        lets a top-level segment split again at the child's cuts).

        Returns a rid releasable with :meth:`broker_release`, or None
        (nothing reserved).  The reservation is a first-class spanning
        entry in this plane's ledger, so conservation and invariants hold
        at every level; if churn or preemption inside this plane later
        displaces it, ``on_broker_displace(rid)`` fires instead of a local
        requeue — the composite belongs to the parent."""
        st = self.span_tenants[tenant]  # KeyError for unregistered
        rid = next(self._rid)
        req = Request(rid, tenant, df, klass=klass)
        ra = int(self.region_of[df.src])
        rb = int(self.region_of[df.dst])
        if ra == rb:
            t = self._reserve_plain(ra, df, tenant, klass)
            if t is None:
                return None
            self.span_stats["broker_local"] += 1
            span = SpanningTicket(
                rid=rid, req=req,
                parts=[SpanPart(ra, t.tid, t.df, self.views[ra].version)],
                cuts=[], cut_bws=[], splits=[],
            )
            self._span_active[rid] = span
            self._part_of[(ra, t.tid)] = rid
        else:
            span = self._try_place_spanning(req)
            if span is None:
                return None
        st.submitted += 1
        st.admitted += 1
        self._broker_held.add(rid)
        return rid

    def broker_release(self, rid: int) -> None:
        """Release (or phase-1 abort) a :meth:`broker_admit` reservation.
        Idempotent: releasing a reservation this plane already displaced
        (and reported via ``on_broker_displace``) is a no-op."""
        if rid not in self._broker_held:
            return
        self._broker_held.discard(rid)
        st = self._span_active.pop(rid)
        self._teardown_span(st)
        self.span_tenants[st.tenant].released += 1

    def broker_uses_node(self, rid: int, v: int) -> bool:
        """Does a broker reservation touch node ``v`` (this plane's id
        space)?  Used by the parent to scope churn displacement."""
        st = self._span_active.get(rid)
        return st is not None and self._span_uses_node(st, int(v))

    def broker_uses_link(self, rid: int, u: int, v: int) -> bool:
        st = self._span_active.get(rid)
        if st is None:
            return False
        return self._span_uses_link(st, int(u), int(v)) or any(
            c in ((int(u), int(v)), (int(v), int(u))) for c in st.cuts
        )

    # -- two-phase commit over the chain -------------------------------------

    def _reserve_plain(self, r: int, seg: DataflowPath, tenant: str,
                       klass: int) -> Optional[Ticket]:
        """Phase-1 reserve of one segment in region ``r`` against its own
        residual only — freely abortable, displaces nothing.  The segment
        (global gateway pins) is compacted into the region's local id
        space here.  A failed reserve is a 2PC probe, not a service
        rejection (the spanning outcome is accounted by the broker's
        ledger/span_stats), so the placer's rejected counter is
        reconciled — same convention as ``admit_preempting``'s probes."""
        placer = self.regions[r].placer
        t = placer.admit(
            self.views[r].compact_df(seg), tenant=tenant, klass=klass
        )
        if t is None:
            placer.stats.rejected -= 1
        return t

    def _reserve_preempting(self, r: int, seg: DataflowPath, tenant: str,
                            klass: int) -> Optional[Ticket]:
        """Preemptive phase-1 reserve under the displaced-cost budget.

        Only called for the LAST missing reservation of a candidate — every
        sibling reservation is already held, so success here guarantees the
        commit and victims are never displaced by an admission that then
        aborts (a failed probe rolls back inside ``admit_preempting``).
        Victims owned by the region's plane re-enter its tenant queues; a
        victim that is itself a spanning segment displaces its whole
        spanning placement back to the broker queue (accounted, never
        dropped)."""
        cp = self.regions[r]
        t, victims = cp.placer.admit_preempting(
            self.views[r].compact_df(seg), tenant=tenant, klass=klass,
            max_displaced_cost=self.preempt_budget,
        )
        if t is None:
            cp.placer.stats.rejected -= 1  # a probe, not a rejection
        if victims:
            for part in cp.preempt_reclaim(victims):
                self._displace_span_part(r, part)
        return t

    def _abort_reservation(self, r: int, ticket: Ticket) -> None:
        """Undo a phase-1 reserve: bookkeeping-only release (no released
        counter, no admitted inflation)."""
        cp = self.regions[r]
        cp.placer.release(ticket.tid, reason=None)
        cp.placer.stats.admitted -= 1  # the reserve never really served

    def _commit_spanning(self, req: Request, chain: list[int], splits,
                         gates, tickets: list[Ticket]) -> SpanningTicket:
        cut_bws = [float(req.df.breq[s]) for s in splits]
        for e, b in zip(gates, cut_bws):
            self.cut_residual[e] -= b
        parts = [
            SpanPart(chain[i], t.tid, t.df, self.views[chain[i]].version)
            for i, t in enumerate(tickets)
        ]
        st = SpanningTicket(
            rid=req.rid, req=req, parts=parts,
            cuts=[tuple(e) for e in gates], cut_bws=cut_bws,
            splits=list(splits),
        )
        self._span_active[req.rid] = st
        for part in parts:
            self._part_of[(part.region, part.tid)] = req.rid
        self.span_stats["admitted"] += 1
        if len(chain) >= 3:
            self.span_stats["multi_hop"] += 1
        self.span_stats["max_chain"] = max(
            self.span_stats["max_chain"], len(chain))
        return st

    def _attempt_candidate(self, req: Request, chain: list[int], splits,
                           gates, can_preempt: bool) -> Optional[SpanningTicket]:
        """One bounded 2PC over every segment of one candidate.

        Reservations are plain (freely abortable) in chain order; at most
        ONE may escalate to budgeted preemption, and only as the *last*
        reservation of the candidate while every sibling is already held —
        so preemption victims are displaced only by an admission that
        commits.  A candidate that cannot complete aborts every
        reservation it took; nothing standing is ever destroyed by a
        failed attempt.  Message cost per candidate is at most
        ``2 * len(chain) + 2`` (prepare/commit per segment, plus the
        nack + preemptive re-prepare of the single blocker).
        """
        df = req.df
        segs = split_dataflow_chain(df, splits, gates)
        held: dict[int, Ticket] = {}
        failed: list[int] = []
        tr = self.tracer
        for i, seg in enumerate(segs):
            self._twopc_msgs += 1  # prepare segment i
            with tr.span("2pc.reserve", track="2pc", cat="2pc",
                         region=chain[i]):
                t = self._reserve_plain(chain[i], seg, req.tenant, req.klass)
            if t is None:
                self._twopc_msgs += 1  # nack i
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.nack", region=chain[i])
                failed.append(i)
                if not can_preempt or len(failed) > 1:
                    break  # candidate dead: >1 blocker can't be rescued
            else:
                held[i] = t
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.reserve", region=chain[i])
        if len(failed) == 1 and can_preempt and len(held) == len(segs) - 1:
            i = failed[0]
            self._twopc_msgs += 1  # prepare i, preemptive retry (last)
            with tr.span("2pc.reserve.preempt", track="2pc", cat="2pc",
                         region=chain[i]):
                t = self._reserve_preempting(chain[i], segs[i],
                                             req.tenant, req.klass)
            if t is None:
                self._twopc_msgs += 1  # nack i
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.nack", region=chain[i],
                                  preempting=True)
            else:
                held[i] = t
                failed = []
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.reserve", region=chain[i],
                                  preempting=True)
        ok = not failed and len(held) == len(segs) and all(
            self.cut_residual[e] + _EPS >= float(df.breq[s])
            for s, e in zip(splits, gates)
        )
        if not ok:
            for i in sorted(held):
                self._twopc_msgs += 1  # abort i
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.abort", region=chain[i])
                self._abort_reservation(chain[i], held[i])
            return None
        self._twopc_msgs += len(segs)  # commit every segment
        if tr.enabled:
            tr.flow_point(req.rid, "2pc.commit", chain=len(segs))
        return self._commit_spanning(
            req, chain, splits, gates, [held[i] for i in range(len(segs))]
        )

    def _try_place_spanning(self, req: Request) -> Optional[SpanningTicket]:
        """Chain selection + bounded 2PC over the cut candidates.  This is
        the single accounting site for spanning placement attempts —
        ``span_stats["attempts"]`` counts every entry here (from the pump
        drain AND from a parent plane's ``broker_admit``), ``admitted``
        every 2PC commit, so ``attempts >= admitted`` holds by
        construction (see :meth:`check_invariants`).

        ``chain_k == 1``: the legacy single fewest-hop region chain over
        the quotient graph, with latency-ordered gate candidates —
        dataflows spanning >= 3 regions decompose into one gateway-pinned
        segment per region instead of retrying until dropped.

        ``chain_k > 1``: Yen k-shortest chains under the load-aware cost
        (the broker's own cut-ledger utilization + gossiped gateway
        occupancy), raced round-robin under the same ``max_cut_attempts``
        2PC budget — when the fewest-hop chain runs hot, a cold bypass
        chain gets probed before the request burns its whole budget."""
        df = req.df
        self.span_stats["attempts"] += 1
        ra = int(self.region_of[df.src])
        rb = int(self.region_of[df.dst])
        can_preempt = self.preempt and req.klass > 0
        if self.chain_k <= 1:
            chain = self._region_chain(ra, rb)
            if chain is None:
                self.span_stats["no_cut"] += 1
                return None
            candidates = self._candidate_chains(df, chain)
            if not candidates:
                self.span_stats["no_cut"] += 1
                return None
            for (splits, gates) in candidates:
                st = self._attempt_candidate(req, chain, splits, gates,
                                             can_preempt)
                if st is not None:
                    return st
            return None
        occ = self.bus.congestion_view(ra)
        chains = self._region_chains(ra, rb, occ)
        if not chains:
            self.span_stats["no_cut"] += 1
            return None
        raced = self._race_candidates(df, chains, occ)
        if not raced:
            self.span_stats["no_cut"] += 1
            return None
        for (chain, splits, gates) in raced:
            st = self._attempt_candidate(req, chain, splits, gates,
                                         can_preempt)
            if st is not None:
                if chain != self._region_chain(ra, rb):
                    self.span_stats["rerouted"] += 1
                return st
        return None

    def _forget_local(self, r: int, lrid: int) -> None:
        """A region terminated (dropped) a local request: the global-rid
        maps must not grow without bound over the plane's lifetime.  The
        plane-level ``on_drop`` hook chains the same cleanup upward when
        this plane is itself a child of a hierarchy."""
        rid = self._grid_of.pop((r, lrid), None)
        if rid is not None:
            self._local.pop(rid, None)
            if self.on_drop is not None:
                self.on_drop(rid)

    def _teardown_span(self, st: SpanningTicket,
                       skip: Optional[tuple[int, int]] = None) -> list[Ticket]:
        """Release every still-live reservation of a spanning placement
        (``skip`` names a (region, tid) already gone, e.g. the preempted
        part) and return the cut bandwidth.  Tolerates parts whose region
        already dropped the local ticket — the teardown must always
        complete for *all* siblings, never leak a partial reservation."""
        old: list[Ticket] = []
        for part in st.parts:
            self._part_of.pop((part.region, part.tid), None)
            if skip is not None and (part.region, part.tid) == skip:
                continue
            tk = self.regions[part.region].placer.tickets.get(part.tid)
            if tk is not None:
                self.regions[part.region].placer.release(part.tid, reason=None)
                old.append(tk)
        for e, b in zip(st.cuts, st.cut_bws):
            self.cut_residual[e] += b
        return old

    def _displace_span_part(self, r: int, part: Ticket) -> None:
        """A spanning segment was preempted (or churn-dropped) out of
        region ``r``: tear down the rest of its composite placement
        (other-region segments + the cut reservations) and requeue the
        whole request with its home region, front of its class band.
        Idempotent — a second displacement of an already-torn-down span
        is a no-op."""
        rid = self._part_of.get((r, part.tid))
        if rid is None:
            return  # not a spanning segment (or span already torn down)
        st = self._span_active.pop(rid, None)
        if st is None:
            self._part_of.pop((r, part.tid), None)
            return
        # the displacement event was already counted once by the victim
        # segment's preemption/drop — siblings are bookkeeping
        old_parts = [part] + self._teardown_span(st, skip=(r, part.tid))
        self.span_stats["displaced"] += 1
        self.span_tenants[st.tenant].preempted += 1
        if self.tracer.enabled:
            self.tracer.flow_point(rid, "displaced", region=r)
        if rid in self._broker_held:
            # a parent plane's reservation: its lifecycle here ends — the
            # parent tears down the composite and requeues at its level
            self._broker_held.discard(rid)
            self.span_tenants[st.tenant].released += 1
            if self.on_broker_displace is not None:
                self.on_broker_displace(rid)
        else:
            self._requeue_or_livelock_drop(st)
        if self._churn_collector is not None:
            self._churn_collector.extend(old_parts)

    # -- release / churn ------------------------------------------------------

    def release(self, rid: int) -> None:
        if rid in self._broker_held:
            raise KeyError(
                f"rid {rid} is a parent-held broker reservation; it is "
                "released through broker_release by the plane that holds it"
            )
        st = self._span_active.pop(rid, None)
        if st is not None:
            # guarded teardown (tolerates a sibling whose region already
            # dropped its local ticket); the request-level release is
            # accounted once, by the broker's ledger — segment releases
            # are regional bookkeeping, exactly like displacement
            self._teardown_span(st)
            self.span_tenants[st.tenant].released += 1
            if self.tracer.enabled:
                self.tracer.flow_end(rid, "release", outcome="released")
            return
        r, lrid = self._local[rid]
        self.regions[r].release(lrid)  # raises if not active (caller bug)
        del self._local[rid]
        del self._grid_of[(r, lrid)]

    def _displace_spans(self, pred) -> list[Ticket]:
        """Tear down every active spanning placement matching ``pred`` and
        requeue its request with its home region (environment displacement
        is handled exactly like preemption: accounted, never dropped).
        Returns the old part tickets, mirroring the centralized churn
        contract."""
        old: list[Ticket] = []
        displaced: list[SpanningTicket] = []
        for rid in [
            g for g, st in self._span_active.items() if pred(st)
        ]:
            st = self._span_active.pop(rid)
            old += self._teardown_span(st)
            self.span_stats["displaced"] += 1
            self.span_tenants[st.tenant].preempted += 1
            if self.tracer.enabled:
                self.tracer.flow_point(rid, "displaced", churn=True)
            if rid in self._broker_held:
                self._broker_held.discard(rid)
                self.span_tenants[st.tenant].released += 1
                if self.on_broker_displace is not None:
                    self.on_broker_displace(rid)
                continue
            displaced.append(st)
        # back-to-front so the batch keeps FIFO-within-class order in any
        # shared home queue (a cumulative-budget drop simply leaves its
        # slot empty)
        for st in reversed(displaced):
            self._requeue_or_livelock_drop(st)
        return old

    def _span_uses_node(self, st: SpanningTicket, v: int) -> bool:
        """Does the placement touch global node ``v`` — as a gateway of
        any hop, or anywhere on a segment's (region-local) route?"""
        for (u, w) in st.cuts:
            if v in (u, w):
                return True
        for part in st.parts:
            view = self.views[part.region]
            if not view.contains(v):
                continue
            lv = view.to_local(v)
            tk = self.regions[part.region].placer.tickets.get(part.tid)
            if tk is not None and lv in tk.mapping.route:
                return True
        return False

    def _span_uses_link(self, st: SpanningTicket, u: int, v: int) -> bool:
        for part in st.parts:
            view = self.views[part.region]
            if not (view.contains(u) and view.contains(v)):
                continue
            lu, lv = view.to_local(u), view.to_local(v)
            tk = self.regions[part.region].placer.tickets.get(part.tid)
            if tk is not None and (
                (lu, lv) in tk.edge_load or (lv, lu) in tk.edge_load
            ):
                return True
        return False

    def _churn_call(self, fn) -> tuple[list[Ticket], list[Ticket]]:
        """Run a region churn operation collecting any spanning placements
        its rescue preemptions displace, so the ``(alive, requeued)``
        return covers every handle the event invalidated."""
        self._churn_collector = hook_old = []
        try:
            alive, requeued = fn()
        finally:
            self._churn_collector = None
        return alive, requeued + hook_old

    def fail_node(self, v: int) -> tuple[list[Ticket], list[Ticket]]:
        """Take global node ``v`` down.  Spanning placements touching it
        (as a gateway or anywhere on a segment route) are displaced back
        to their broker queues first, then the owning region re-maps its
        local tickets on the degraded subgraph (in its local id space; the
        region's view is invalidated — bijection generation bumped).  Same
        ``(alive, requeued)`` contract as the centralized plane;
        ``requeued`` also covers spanning placements displaced by rescue
        preemptions during the re-map."""
        v = int(v)
        self.node_up[v] = False
        requeued_span = self._displace_spans(
            lambda st: self._span_uses_node(st, v)
        )
        r = int(self.region_of[v])
        self.views[r].invalidate()
        lv = int(self.views[r].to_local(v))
        alive, requeued = self._churn_call(
            lambda: self.regions[r].fail_node(lv)
        )
        return alive, requeued + requeued_span

    def fail_link(self, u: int, v: int) -> tuple[list[Ticket], list[Ticket]]:
        """Take a (symmetric) link down: an in-region link fails through
        the owning region (translated to its local id space); a *cut*
        link degrades the quotient graph — every spanning placement riding
        it is displaced and requeued, and chains re-route around it on the
        next pump (healed by ``restore_link``)."""
        u, v = int(u), int(v)
        if self.region_of[u] == self.region_of[v]:
            # spanning segments routed over the link must leave through the
            # broker (the inner remap cannot requeue a composite placement)
            requeued_span = self._displace_spans(
                lambda st: self._span_uses_link(st, u, v)
            )
            r = int(self.region_of[u])
            self.views[r].invalidate()
            lu, lv = int(self.views[r].to_local(u)), int(self.views[r].to_local(v))
            alive, requeued = self._churn_call(
                lambda: self.regions[r].fail_link(lu, lv)
            )
            return alive, requeued + requeued_span
        for e in ((u, v), (v, u)):
            if e in self.cut_link_up:
                self.cut_link_up[e] = False
        requeued_span = self._displace_spans(
            lambda st: any(c in ((u, v), (v, u)) for c in st.cuts)
        )
        return [], requeued_span

    def restore_node(self, v: int) -> None:
        v = int(v)
        self.node_up[v] = True
        r = int(self.region_of[v])
        self.views[r].invalidate()
        self.regions[r].restore_node(int(self.views[r].to_local(v)))

    def restore_link(self, u: int, v: int) -> None:
        u, v = int(u), int(v)
        if self.region_of[u] == self.region_of[v]:
            r = int(self.region_of[u])
            self.views[r].invalidate()
            self.regions[r].restore_link(
                int(self.views[r].to_local(u)), int(self.views[r].to_local(v))
            )
            return
        for e in ((u, v), (v, u)):
            if e in self.cut_link_up:
                self.cut_link_up[e] = bool(np.isfinite(self.base.lat[e]))

    # -- defragmentation ------------------------------------------------------

    def defrag(self, *, max_extras: Optional[int] = None) -> list:
        """Per-region re-optimization — there is deliberately no global
        re-solve (that would be the centralized plane again).  Spanning
        segments are standing tickets with pinned gateways, so each region
        may re-pack them locally; tids (and thus spanning handles) are
        preserved.  Returns one DefragResult per region."""
        return [cp.defrag(max_extras=max_extras) for cp in self.regions]

    # -- reporting / invariants ----------------------------------------------

    def _kernel_impl_counts(self) -> dict:
        """Per-backend solve counts summed over every region's placer."""
        out: dict[str, int] = {}
        for cp in self.regions:
            for k, v in cp._kernel_impl_counts().items():
                out[k] = out.get(k, 0) + v
        return out

    def _solve_counts(self) -> tuple[int, int]:
        solves = n_sum = 0
        for cp in self.regions:
            s, n = cp._solve_counts()
            solves += s
            n_sum += n
        return solves, n_sum

    def engine_stats(self) -> engine.Stats:
        s = engine.Stats(method=self.method)
        s.preemptions = sum(
            cp.placer.stats.preempted for cp in self.regions)
        s.defrag_rounds = sum(
            cp.placer.stats.defrag_rounds for cp in self.regions)
        s.solve_ms = sum(cp.placer.stats.solve_ms for cp in self.regions)
        s.overhead_ms = sum(
            cp.placer.stats.overhead_ms for cp in self.regions)
        s.conflict_resolve_ms = sum(
            cp.placer.stats.conflict_resolve_ms for cp in self.regions)
        s.stale_batches = sum(
            cp.placer.stats.stale_batches for cp in self.regions)
        s.batch_size = self.micro_batch
        s.rounds = self.bus.rounds
        s.gossip_messages = self.bus.messages_sent
        s.twopc_messages = self._twopc_msgs
        s.messages_sent = s.gossip_messages + s.twopc_messages
        solves, n_sum = self._solve_counts()
        if solves:
            s.solve_n = round(n_sum / solves)
        # the non-additive fields fold as labeled consensus, not a sum:
        # the mix of backends that actually ran, never a silent drop
        s.kernel_impl = ControlPlane._consensus_impl(
            self._kernel_impl_counts())
        return s

    def metrics_registry(self) -> obs_metrics.MetricsRegistry:
        """One merged registry: every region's registry labeled
        ``plane=r{r}`` (mirroring the gossip aggregation direction), plus
        the broker's own gossip / 2PC / spanning counters."""
        reg = obs_metrics.MetricsRegistry()
        for r, cp in enumerate(self.regions):
            reg.merge(cp.metrics_registry(), plane=f"r{r}")
        obs_metrics.absorb_gossip_stats(reg, self.bus.gossip_stats())
        obs_metrics.absorb_span_stats(reg, self.span_stats)
        reg.inc("twopc.messages", float(self._twopc_msgs))
        return reg

    def solve_size_report(self) -> dict:
        """The compute-locality story in numbers: the padded node
        dimension every regional DP actually ran over, next to the global
        ``n`` the masked (pre-compaction) plane would have paid."""
        per = []
        for r, cp in enumerate(self.regions):
            st = cp.placer.stats
            per.append({
                "region": r,
                "n_r": self.views[r].n_local,
                "solves": st.solves,
                "mean_solve_n": st.mean_solve_n,
            })
        solves = sum(p["solves"] for p in per)
        nsum = sum(cp.placer.stats.solve_n_sum for cp in self.regions)
        return {
            "global_n": self.base.n,
            "regions": per,
            "solves": solves,
            "mean_solve_n": (nsum / solves) if solves else 0.0,
            "max_solve_n": max(
                (p["n_r"] for p in per if p["solves"]), default=0),
            "balanced_n_r": math.ceil(self.base.n / max(self.R, 1)),
        }

    def resident_state_report(self) -> dict:
        """Max per-component resident state — the scaling metric the
        hierarchical plane is graded on.  Each region holds its
        ``n_r``-sized solve/residual state plus one gossip record per peer
        (R at steady state); the broker holds the quotient graph (R) plus
        its boundary id table — the distinct gateway node ids in the cut
        ledger.  A flat plane's broker is therefore O(boundary + R); the
        hierarchy keeps every level's boundary and peer count at
        O(branching)."""
        gateway_ids = {v for e in self.cut_base for v in e}
        comps = [{
            "component": "broker",
            "id_table": len(gateway_ids),
            "peers": self.R,
            "state": len(gateway_ids) + self.R,
        }]
        for r in range(self.R):
            comps.append({
                "component": f"region[{r}]",
                "solve_n": self.views[r].n_local,
                "peers": self.R,
                "state": self.views[r].n_local + self.R,
            })
        return {
            "components": comps,
            "max_component_state": max(c["state"] for c in comps),
        }

    def coordination_report(self) -> dict:
        """The decentralization story in numbers: gossip volume/staleness
        and 2PC traffic next to the spanning admission outcomes and the
        compacted solve sizes."""
        return {
            "regions": self.R,
            "fanout": self.bus.fanout,
            "gossip_period": self.gossip_period,
            "gossip_rounds": self.bus.rounds,
            "gossip_messages": self.bus.messages_sent,
            "gossip_messages_per_round": (
                self.bus.messages_sent / max(self.bus.rounds, 1)
            ),
            "max_staleness": self.bus.max_staleness(),
            "gossip": self.bus.gossip_stats(),
            "twopc_messages": self._twopc_msgs,
            "spanning": dict(self.span_stats),
            "cut_edges": len(self.cut_base),
            "solve_size": self.solve_size_report(),
            "resident": self.resident_state_report(),
        }

    def fairness_report(self) -> dict:
        rep = fairness_summary(
            self.committed_capacity(),
            self.queued_demand(),
            {t: st.cfg.weight for t, st in self.span_tenants.items()},
        )
        rep["coordination"] = self.coordination_report()
        rep["timing"] = {
            "solve_ms": sum(
                cp.placer.stats.solve_ms for cp in self.regions),
            "overhead_ms": sum(
                cp.placer.stats.overhead_ms for cp in self.regions),
            "conflict_resolve_ms": sum(
                cp.placer.stats.conflict_resolve_ms for cp in self.regions),
        }
        return rep

    def check_invariants(self) -> None:
        """Every region's placer + ledger invariants, the global ledger,
        cut-bandwidth conservation, spanning-handle integrity (liveness,
        chain well-formedness, bijection versions), and the write-through
        global conservation of the compacted substrate: the per-region
        local residuals + local ticket loads, lifted through the views,
        must re-assemble the base network exactly."""
        for cp in self.regions:
            cp.check_invariants()
        led = self.conservation()
        assert led["ok"], f"global ticket conservation violated: {led}"
        # span accounting: attempts/admitted are counted at exactly one
        # site each (_try_place_spanning entry / 2PC commit), so the
        # counters nest strictly — a double-count on any path breaks this
        ss = self.span_stats
        assert 0 <= ss["admitted"] <= ss["attempts"], (
            f"span accounting violated: {ss}")
        assert ss["multi_hop"] <= ss["admitted"], (
            f"span accounting violated: {ss}")
        assert ss["rerouted"] <= ss["admitted"], (
            f"span accounting violated: {ss}")
        assert ss["livelock_dropped"] <= ss["dropped"] <= ss["attempts"], (
            f"span accounting violated: {ss}")
        assert len(self._span_active) <= ss["admitted"] + ss["broker_local"], (
            f"more active spans than admissions: {ss}")
        reserved = {e: 0.0 for e in self.cut_base}
        for st in self._span_active.values():
            for e, b in zip(st.cuts, st.cut_bws):
                reserved[e] += b
        for e, base_bw in self.cut_base.items():
            assert abs(self.cut_residual[e] + reserved[e] - base_bw) < 1e-6, (
                f"cut bandwidth conservation violated on {e}"
            )
            assert self.cut_residual[e] >= -1e-6, (
                f"negative cut residual on {e}"
            )
        for rid, st in self._span_active.items():
            assert len(st.parts) == len(st.cuts) + 1, (
                f"spanning rid {rid}: chain/cut arity mismatch"
            )
            assert list(st.splits) == sorted(st.splits), (
                f"spanning rid {rid}: splits not non-decreasing"
            )
            for i, (u, v) in enumerate(st.cuts):
                assert int(self.region_of[u]) == st.parts[i].region
                assert int(self.region_of[v]) == st.parts[i + 1].region
            for part in st.parts:
                tk = self.regions[part.region].placer.tickets.get(part.tid)
                assert tk is not None and tk.df is part.seg, (
                    f"spanning rid {rid} holds a stale segment in region "
                    f"{part.region}"
                )
                assert self._part_of.get((part.region, part.tid)) == rid
                assert part.version <= self.views[part.region].version, (
                    f"spanning rid {rid}: part minted under a future "
                    "bijection version"
                )
        # write-through conservation: re-assemble the global network from
        # the compacted regional state.  Node capacity must reconstruct
        # exactly; in-region bandwidth likewise; cut bandwidth is checked
        # above (it belongs to the broker, not to any region).
        cap_res = np.zeros(self.base.n)
        cap_load = np.zeros(self.base.n)
        bw_res = np.zeros((self.base.n, self.base.n))
        bw_load = np.zeros((self.base.n, self.base.n))
        in_region = np.zeros((self.base.n, self.base.n), bool)
        for r, cp in enumerate(self.regions):
            view = self.views[r]
            cap_res += view.uncompact_node_vec(cp.placer.cap)
            bw_res += view.uncompact_link_mat(cp.placer.bw)
            in_region |= view.uncompact_link_mat(
                np.ones((view.n_local, view.n_local), bool))
            for tk in cp.placer.tickets.values():
                for gv, c in view.uncompact_node_load(tk.node_load).items():
                    cap_load[gv] += c
                for (gu, gv), b in view.uncompact_edge_load(
                        tk.edge_load).items():
                    bw_load[gu, gv] += b
        assert np.allclose(cap_res + cap_load, self.base.cap, atol=1e-4), (
            "compacted-view write-through broke node-capacity conservation"
        )
        assert np.allclose(
            (bw_res + bw_load)[in_region], self.base.bw[in_region], atol=1e-4
        ), "compacted-view write-through broke link-bandwidth conservation"
