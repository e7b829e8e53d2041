"""Hierarchical regional control plane: regions of regions, recursively.

Port of ``repro/service/hierarchy.py``: ``device=`` reaches every leaf
plane's placers in place of ``use_kernel``.

The flat :class:`~repro_torch.service.regions.RegionalControlPlane` decentralizes
admission, but two of its components still scale with the whole plane: the
broker holds every global gateway id, and the gossip bus is all-to-all in
R.  Past a few hundred regions that is the centralized bottleneck again,
one level up.  This module nests the plane instead::

    HierarchicalControlPlane (levels=L, branching=b)
      ids: GLOBAL — but only at its own boundary (top-level cut gateways)
      owns: top cut ledger, top spanning queues, one GossipBus over its
            b children (aggregated records)
        |
        +-- child g in 0..b-1: a CompactedView of group g's nodes, and
            under it a plane of levels L-1 (RegionalControlPlane at the
            bottom) whose ids are the view's LOCAL space [0, n_g)
              ... recursing until b leaf regions of ~n^(1/L) nodes each

Identity discipline — which component owns which ids:

- every level's broker sees exactly two id kinds: its own boundary
  gateways (cut ledger) and opaque child rids.  It never sees a
  grandchild id; translation happens once per level, at the
  ``CompactedView`` boundary (bijection-of-bijection by construction).
- spanning decomposition **recurses**: a dataflow crossing a top-level
  cut is chain-split at this level (same quotient-graph machinery as the
  flat plane, via the shared :class:`~repro_torch.service.regions.ChainBroker`),
  and each segment is handed to its child through
  ``broker_admit`` — a synchronous, abortable phase-1 reserve.  The child
  places the segment as its OWN spanning problem, so it may split again
  at its own cuts.  Abort/commit are O(chain) messages per level.
- gossip is tree-structured: siblings gossip within their parent only
  (``b * fanout`` msgs/round per level, each message carrying at most
  ``b`` *aggregated* records), and each parent publishes the summed
  remote estimate downward through ``pump(extra_committed=...)`` — so no
  component ever holds more than O(branching + n_leaf) state.

The ``levels=1`` plane is a single flat child under the identity view
with pure delegation — bit-identical to :class:`RegionalControlPlane` by
construction (the same composition argument that makes R=1 bit-identical
to the centralized plane), and fuzz-enforced in ``tests/test_hierarchy``.
"""
from __future__ import annotations

import collections
import itertools
from typing import Optional

import numpy as np

from ..core import engine
from ..core.compact import CompactedView
from ..core.graph import DataflowPath, ResourceGraph
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .controlplane import ControlPlane, Request, TenantState
from .gossip import GossipBus
from .policy import FairSharePolicy, TenantConfig, fairness_summary
from .regions import (
    ChainBroker,
    RegionalControlPlane,
    SpanPart,
    SpanningTicket,
    partition_regions,
    split_dataflow_chain,
    validate_region_of,
)

_EPS = 1e-9


def resolve_nesting(levels, branching, regions, detected_leaves=None):
    """Fail-fast resolution of the nesting kwargs into
    ``(levels, branching, leaf_regions)``.  Contradictory combinations
    raise with a clear message instead of silently building some other
    plane (mirrors the flat plane's ``regions=`` vs ``region_of=``
    contradiction check)."""
    levels = int(levels)
    if levels < 1:
        raise ValueError(f"levels={levels} must be >= 1")
    leaves = detected_leaves
    if regions is not None:
        if leaves is not None and int(regions) != leaves:
            raise ValueError(
                f"regions={regions} contradicts region_of, which defines "
                f"{leaves} regions"
            )
        leaves = int(regions)
    if levels == 1:
        if branching is not None and leaves is not None \
                and int(branching) != leaves:
            raise ValueError(
                f"branching={branching} contradicts {leaves} leaf regions "
                "at levels=1 (a 1-level plane has branching == regions)"
            )
        if leaves is None:
            leaves = int(branching) if branching is not None else 2
        return levels, leaves, leaves
    if branching is None:
        if leaves is None:
            branching = 2
        else:
            branching = round(leaves ** (1.0 / levels))
            if branching**levels != leaves:
                raise ValueError(
                    f"regions={leaves} is not a perfect levels={levels} "
                    "power; pass branching= explicitly (leaf regions = "
                    "branching ** levels)"
                )
    branching = int(branching)
    if branching < 1:
        raise ValueError(f"branching={branching} must be >= 1")
    if leaves is not None and branching**levels != leaves:
        raise ValueError(
            f"regions={leaves} contradicts levels={levels} x "
            f"branching={branching} (expected {branching ** levels} "
            "leaf regions)"
        )
    return levels, branching, branching**levels


class HierarchicalControlPlane(ChainBroker):
    """``levels`` nested regional planes with ``branching`` children per
    level.  Mirrors the plane-agnostic surface of
    :class:`RegionalControlPlane` (register_tenant / submit / pump /
    release / fail_* / restore_* / defrag / conservation /
    fairness_report / engine_stats / check_invariants / active_ids), plus
    the ``broker_admit`` / ``broker_release`` parent-broker interface so
    hierarchies nest to any depth.  ``**solve_cfg`` (including the
    incremental-fast-path knobs ``cache_enabled`` / ``cache_size`` /
    ``max_correction_supersteps``) propagates through every level down to
    the leaf planes' per-region placers."""

    def __init__(
        self,
        rg: ResourceGraph,
        *,
        levels: int = 2,
        branching: Optional[int] = None,
        regions: Optional[int] = None,
        region_of=None,
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
        # each child gets a scoped view of this tracer ("g{g}/" prefixes),
        # so flow ids and track names nest the way the planes do
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        assign = None
        if region_of is not None:
            assign = validate_region_of(rg, region_of)
        self.levels, self.branching, leaves = resolve_nesting(
            levels, branching, regions,
            detected_leaves=(int(assign.max()) + 1 if assign is not None
                             else None),
        )
        self.policy = policy or FairSharePolicy()
        self.micro_batch = int(micro_batch)
        self.max_attempts = int(max_attempts)
        self.max_cut_attempts = int(max_cut_attempts)
        # same routing/backoff knobs at every level of the tree: the
        # recursive spanning decomposition races congestion-priced chains
        # with the same k and weight wherever a segment lands
        self.chain_k = max(1, int(chain_k))
        self.congestion_weight = float(congestion_weight)
        self.max_cum_attempts = (
            4 * self.max_attempts if max_cum_attempts is None
            else int(max_cum_attempts)
        )
        self.gossip_period = max(1, int(gossip_period))
        self.method = method
        self.node_up = np.ones(rg.n, bool)
        child_kw = dict(
            policy=self.policy, micro_batch=micro_batch,
            max_attempts=max_attempts, preempt=preempt,
            preempt_budget=preempt_budget, pipeline_depth=pipeline_depth,
            method=method, device=device, fanout=fanout,
            gossip_period=gossip_period, max_cut_attempts=max_cut_attempts,
            chain_k=chain_k, congestion_weight=congestion_weight,
            max_cum_attempts=max_cum_attempts,
            **solve_cfg,
        )

        if self.levels == 1:
            # the flat special case: ONE child over the identity view,
            # pure delegation — bit-identical to RegionalControlPlane by
            # construction (same seed, same kwargs, same object graph)
            self.B = 1
            self.group_of = np.zeros(rg.n, np.int64)
            self.views = [CompactedView.identity(rg)]
            self.children: list = [RegionalControlPlane(
                rg,
                regions=(None if assign is not None
                         else leaves if (regions is not None
                                         or branching is not None)
                         else None),
                region_of=assign, seed=seed,
                tracer=self.tracer.scoped("g0"), **child_kw,
            )]
        else:
            self.B = self.branching
            sub = self.branching ** (self.levels - 1)  # leaves per child
            if assign is not None:
                self.group_of = assign // sub
            else:
                self.group_of = partition_regions(rg, self.B, seed=seed)
            self.views = [
                CompactedView.from_assign(rg, self.group_of, g)
                for g in range(self.B)
            ]
            self.children = []
            for g in range(self.B):
                view = self.views[g]
                base_g = view.graph()
                inner = (assign[view.nodes] - g * sub
                         if assign is not None else None)
                if self.levels == 2:
                    child = RegionalControlPlane(
                        base_g,
                        regions=(None if inner is not None else self.branching),
                        region_of=inner, seed=seed + 1000 * (g + 1),
                        tracer=self.tracer.scoped(f"g{g}"), **child_kw,
                    )
                else:
                    child = HierarchicalControlPlane(
                        base_g, levels=self.levels - 1,
                        branching=self.branching, region_of=inner,
                        seed=seed + 1000 * (g + 1),
                        tracer=self.tracer.scoped(f"g{g}"), **child_kw,
                    )
                self.children.append(child)
        # link child views into the derivation chain so a leaf churn's
        # invalidate() propagates up to this level's views (and a parent
        # invalidation cascades down) — bijection-of-bijection versioning
        for g, child in enumerate(self.children):
            for cv in child.views:
                self.views[g].adopt(cv)
            child.on_broker_displace = (
                lambda crid, g=g: self._child_displaced(g, crid))
            child.on_drop = (lambda crid, g=g: self._forget_local(g, crid))

        # node -> leaf region over the WHOLE tree (reporting convenience;
        # the plane itself never indexes by it)
        self.leaf_region_of = np.zeros(rg.n, np.int64)
        off = 0
        for g, (view, child) in enumerate(zip(self.views, self.children)):
            inner_leaf = (child.leaf_region_of
                          if isinstance(child, HierarchicalControlPlane)
                          else child.region_of)
            self.leaf_region_of[view.nodes] = off + inner_leaf
            off += int(inner_leaf.max()) + 1
        self.leaf_regions = off

        # this level's broker: region_of maps node -> direct child
        self.region_of = self.group_of
        self._init_cut_ledger()
        self.bus = GossipBus(self.B, fanout=fanout, seed=seed + 7)

        self.span_tenants: dict[str, TenantState] = {}
        self._span_q: list[dict[str, collections.deque]] = [
            {} for _ in range(self.B)
        ]
        self._span_active: dict[int, SpanningTicket] = {}
        self._part_of: dict[tuple[int, int], int] = {}  # (group, crid) -> rid
        self._rid = itertools.count()
        self._local: dict[int, tuple[int, int]] = {}  # rid -> (group, crid)
        self._grid_of: dict[tuple[int, int], int] = {}  # (group, crid) -> rid
        self._pumps = 0
        self._twopc_msgs = 0
        self._churn_collector: Optional[list] = None
        self._broker_held: set[int] = set()
        self.on_broker_displace = None
        self.on_drop = None
        self.span_stats = {
            "attempts": 0, "admitted": 0, "dropped": 0,
            "displaced": 0, "no_cut": 0, "multi_hop": 0, "max_chain": 0,
            "broker_local": 0, "rerouted": 0, "livelock_dropped": 0,
            "max_req_attempts": 0,
        }

    # -- registration / submission ------------------------------------------

    def register_tenant(
        self, name: str, *, weight: float = 1.0,
        budget: Optional[float] = None,
    ) -> TenantConfig:
        if name in self.span_tenants:
            raise ValueError(f"tenant {name!r} already registered")
        cfg = TenantConfig(name, weight=weight, budget=budget)
        for child in self.children:
            child.register_tenant(name, weight=weight, budget=budget)
        self.span_tenants[name] = TenantState(cfg)
        for q in self._span_q:
            q[name] = collections.deque()
        return cfg

    def submit(self, tenant: str, df: DataflowPath, *, klass: int = 0) -> int:
        """Queue a request; one whose endpoints stay inside a single child
        delegates (compacted to the child's id space — the child may still
        split it across ITS children); one crossing a top-level cut queues
        with the source group's broker side and is placed by this level's
        2PC at pump time."""
        st = self.span_tenants[tenant]  # KeyError for unregistered
        rid = next(self._rid)
        ga = int(self.group_of[df.src])
        gb = int(self.group_of[df.dst])
        if ga == gb:
            crid = self.children[ga].submit(
                tenant, self.views[ga].compact_df(df), klass=klass
            )
            self._local[rid] = (ga, crid)
            self._grid_of[(ga, crid)] = rid
        else:
            st.submitted += 1
            ControlPlane._enqueue(
                self._span_q[ga][tenant], Request(rid, tenant, df, klass=klass)
            )
            if self.tracer.enabled:
                self.tracer.flow_begin(
                    rid, "submit", tenant=tenant, klass=klass,
                    spanning=True, home=ga,
                )
        return rid

    # -- live accounting -----------------------------------------------------

    def committed_capacity(self) -> dict[str, float]:
        held = {t: 0.0 for t in self.span_tenants}
        for child in self.children:
            for t, c in child.committed_capacity().items():
                held[t] = held.get(t, 0.0) + c
        return held

    def residual_capacity(self) -> float:
        return float(sum(c.residual_capacity() for c in self.children))

    def queued_demand(self) -> dict[str, float]:
        out = {t: 0.0 for t in self.span_tenants}
        for child in self.children:
            for t, c in child.queued_demand().items():
                out[t] = out.get(t, 0.0) + c
        for q in self._span_q:
            for t, dq in q.items():
                out[t] += sum(r.creq_sum for r in dq)
        return out

    def active_ids(self) -> list[int]:
        out = [
            self._grid_of[(g, crid)]
            for g, child in enumerate(self.children)
            for crid in child.active_ids()
            if (g, crid) in self._grid_of
        ]
        out += [rid for rid in self._span_active
                if rid not in self._broker_held]
        return sorted(out)

    def ticket_live(self, t) -> bool:
        if self._span_active.get(getattr(t, "rid", -1)) is t:
            return True
        return any(child.ticket_live(t) for child in self.children)

    def conservation(self) -> dict[str, int]:
        """Children's ledgers + this level's spanning ledger.  Each level
        accounts its own requests; a top spanning request contributes one
        entry here plus one broker-held entry per segment in its child —
        both sides balance independently, so ``ok`` composes."""
        agg = {"submitted": 0, "queued": 0, "in_flight": 0, "active": 0,
               "released": 0, "dropped": 0}
        for child in self.children:
            led = child.conservation()
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

    # -- gossip (tree-structured) --------------------------------------------

    def node_occupancy(self, v: int) -> float:
        """Compute occupancy of node ``v`` (this plane's id space) in
        [0, 1]: recurses down the tree to the leaf region placer that
        holds the node's live residual."""
        g = int(self.group_of[v])
        return self.children[g].node_occupancy(
            int(self.views[g].to_local(v)))

    def _gateway_occupancy(self, g: int) -> dict[int, float]:
        """Occupancy of child ``g``'s gateway nodes at THIS level's cuts
        (this plane's ids) — the per-cut congestion estimate the tree
        gossip disseminates among siblings, read from the child's leaf
        placers, regardless of how many levels it hides."""
        view = self.views[g]
        return {
            u: self.children[g].node_occupancy(int(view.to_local(u)))
            for u in self._gateways_of.get(g, ())
        }

    def _publish(self, g: int) -> None:
        """Publish child g's AGGREGATED accounting into this level's bus:
        one record per child, regardless of how many leaves it hides."""
        child = self.children[g]
        queued = child.queued_demand()
        for t, dq in self._span_q[g].items():
            queued[t] = queued.get(t, 0.0) + sum(x.creq_sum for x in dq)
        self.bus.publish(
            g, child.committed_capacity(), queued, child.residual_capacity(),
            congestion=self._gateway_occupancy(g),
        )

    # -- admission -----------------------------------------------------------

    def pump(self, *, rounds: int = 1, extra_committed=None) -> list:
        """One drain round per ``rounds`` at every level: publish +
        sibling gossip at this level, push the aggregated remote estimate
        DOWN into each child's drain (``extra_committed`` — the tree
        downlink), recurse, then place this level's spanning queue by
        recursive 2PC."""
        admitted: list = []
        spanned: list[SpanningTicket] = []
        for _ in range(int(rounds)):
            self._pumps += 1
            for g in range(self.B):
                self._publish(g)
            if self.B > 1 and self._pumps % self.gossip_period == 0:
                with self.tracer.span("gossip.round", track="gossip",
                                      cat="gossip", round=self._pumps):
                    self.bus.tick()
            for g, child in enumerate(self.children):
                extra: dict[str, float] = dict(extra_committed or {})
                if self.B > 1:
                    for t, c in self.bus.remote_committed(g).items():
                        extra[t] = extra.get(t, 0.0) + c
                admitted += child.pump(rounds=1, extra_committed=extra or None)
            spanned += self._pump_spanning(extra_committed)
        live = [t for t in admitted if self.ticket_live(t)]
        live += [s for s in spanned if s.rid in self._span_active]
        return live

    def flush(self) -> list:
        admitted: list = []
        for child in self.children:
            admitted += child.flush()
        return [t for t in admitted if self.ticket_live(t)]

    def warmup(self, *, max_batch: Optional[int] = None, p: int = 5) -> int:
        return max(
            (c.warmup(max_batch=max_batch, p=p) for c in self.children),
            default=0,
        )

    def _pump_spanning(self, extra_committed=None) -> list[SpanningTicket]:
        if self.B <= 1:
            return []
        out: list[SpanningTicket] = []
        cfgs = {t: st.cfg for t, st in self.span_tenants.items()}
        for g in range(self.B):
            queues = self._span_q[g]
            if not any(queues.values()):
                continue
            committed = self.children[g].committed_capacity()
            for t, c in self.bus.remote_committed(g).items():
                if t in committed:
                    committed[t] += c
            for t, c in (extra_committed or {}).items():
                if t in committed:
                    committed[t] += c
            picked = self.policy.select(
                cfgs, queues, committed, self.micro_batch
            )
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

    # -- recursive two-phase commit -----------------------------------------

    def _attempt_candidate(self, req: Request, chain: list[int], splits,
                           gates) -> Optional[SpanningTicket]:
        """One bounded 2PC over a candidate at THIS level: each segment's
        phase-1 reserve is the child's ``broker_admit`` — inside which the
        child may run its own chain split and its own (recursive) 2PC.
        This level never sees how the child placed the segment; it holds
        an opaque child rid.  No preemptive escalation at interior levels
        (a child's broker_admit already applies its own local policy);
        abort releases every held child reservation."""
        df = req.df
        segs = split_dataflow_chain(df, splits, gates)
        held: dict[int, int] = {}
        seg_local: dict[int, DataflowPath] = {}
        ok = True
        tr = self.tracer
        for i, seg in enumerate(segs):
            self._twopc_msgs += 1  # prepare segment i
            g = chain[i]
            lseg = self.views[g].compact_df(seg)
            with tr.span("2pc.reserve", track="2pc", cat="2pc", group=g):
                crid = self.children[g].broker_admit(
                    req.tenant, lseg, klass=req.klass)
            if crid is None:
                self._twopc_msgs += 1  # nack i
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.nack", region=g)
                ok = False
                break
            held[i] = crid
            seg_local[i] = lseg
            if tr.enabled:
                tr.flow_point(req.rid, "2pc.reserve", region=g)
        ok = ok and all(
            self.cut_residual[e] + _EPS >= float(df.breq[s])
            for s, e in zip(splits, gates)
        )
        if not ok:
            for i in sorted(held):
                self._twopc_msgs += 1  # abort i
                if tr.enabled:
                    tr.flow_point(req.rid, "2pc.abort", region=chain[i])
                self.children[chain[i]].broker_release(held[i])
            return None
        self._twopc_msgs += len(segs)  # commit every segment
        if tr.enabled:
            tr.flow_point(req.rid, "2pc.commit", chain=len(segs))
        cut_bws = [float(df.breq[s]) for s in splits]
        for e, b in zip(gates, cut_bws):
            self.cut_residual[e] -= b
        parts = [
            SpanPart(chain[i], held[i], seg_local[i],
                     self.views[chain[i]].version)
            for i in range(len(segs))
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

    def _try_place_spanning(self, req: Request) -> Optional[SpanningTicket]:
        """Chain selection + recursive 2PC — the single accounting site
        for this level's spanning attempts/admissions, mirroring
        :meth:`RegionalControlPlane._try_place_spanning`: ``chain_k == 1``
        takes the legacy fewest-hop chain; ``chain_k > 1`` races Yen
        k-shortest chains under the load-aware cost fed by this level's
        sibling gossip, within the same ``max_cut_attempts`` budget."""
        df = req.df
        self.span_stats["attempts"] += 1
        ga = int(self.group_of[df.src])
        gb = int(self.group_of[df.dst])
        if self.chain_k <= 1:
            chain = self._region_chain(ga, gb)
            if chain is None:
                self.span_stats["no_cut"] += 1
                return None
            candidates = self._candidate_chains(df, chain)
            if not candidates:
                self.span_stats["no_cut"] += 1
                return None
            for (splits, gates) in candidates:
                st = self._attempt_candidate(req, chain, splits, gates)
                if st is not None:
                    return st
            return None
        occ = self.bus.congestion_view(ga)
        chains = self._region_chains(ga, gb, occ)
        if not chains:
            self.span_stats["no_cut"] += 1
            return None
        raced = self._race_candidates(df, chains, occ)
        if not raced:
            self.span_stats["no_cut"] += 1
            return None
        for (chain, splits, gates) in raced:
            st = self._attempt_candidate(req, chain, splits, gates)
            if st is not None:
                if chain != self._region_chain(ga, gb):
                    self.span_stats["rerouted"] += 1
                return st
        return None

    # -- parent-plane broker interface (nesting deeper) ----------------------

    def broker_admit(self, tenant: str, df: DataflowPath, *,
                     klass: int = 0) -> Optional[int]:
        """Same contract as :meth:`RegionalControlPlane.broker_admit`, one
        level up: a grandparent's segment lands here and is placed either
        inside one of this plane's children or across its own cuts."""
        st = self.span_tenants[tenant]
        rid = next(self._rid)
        req = Request(rid, tenant, df, klass=klass)
        ga = int(self.group_of[df.src])
        gb = int(self.group_of[df.dst])
        if ga == gb:
            lseg = self.views[ga].compact_df(df)
            crid = self.children[ga].broker_admit(tenant, lseg, klass=klass)
            if crid is None:
                return None
            self.span_stats["broker_local"] += 1
            span = SpanningTicket(
                rid=rid, req=req,
                parts=[SpanPart(ga, crid, lseg, self.views[ga].version)],
                cuts=[], cut_bws=[], splits=[],
            )
            self._span_active[rid] = span
            self._part_of[(ga, crid)] = rid
        else:
            span = self._try_place_spanning(req)
            if span is None:
                return None
        st.submitted += 1
        st.admitted += 1
        self._broker_held.add(rid)
        return rid

    def broker_release(self, rid: int) -> None:
        if rid not in self._broker_held:
            return
        self._broker_held.discard(rid)
        st = self._span_active.pop(rid)
        self._teardown_span(st)
        self.span_tenants[st.tenant].released += 1

    def broker_uses_node(self, rid: int, v: int) -> bool:
        st = self._span_active.get(rid)
        return st is not None and self._span_uses_node(st, int(v))

    def broker_uses_link(self, rid: int, u: int, v: int) -> bool:
        st = self._span_active.get(rid)
        if st is None:
            return False
        u, v = int(u), int(v)
        if any(c in ((u, v), (v, u)) for c in st.cuts):
            return True
        ga, gb = int(self.group_of[u]), int(self.group_of[v])
        if ga != gb:
            return False
        view = self.views[ga]
        for part in st.parts:
            if part.region != ga:
                continue
            if self.children[ga].broker_uses_link(
                    part.tid, int(view.to_local(u)), int(view.to_local(v))):
                return True
        return False

    # -- teardown / displacement ---------------------------------------------

    def _teardown_span(self, st: SpanningTicket,
                       skip: Optional[tuple[int, int]] = None) -> None:
        """Release every still-held child reservation of a top spanning
        placement (``skip`` names a (group, crid) the child already
        displaced) and return this level's cut bandwidth.  Child releases
        are idempotent, so the teardown always completes."""
        for part in st.parts:
            self._part_of.pop((part.region, part.tid), None)
            if skip is not None and (part.region, part.tid) == skip:
                continue
            self.children[part.region].broker_release(part.tid)
        for e, b in zip(st.cuts, st.cut_bws):
            self.cut_residual[e] += b

    def _drop_or_requeue(self, rid: int, st: SpanningTicket) -> bool:
        """After a displacement teardown: hand a parent-held reservation
        up, or requeue an owned request at its home group (dropping it if
        its cumulative attempt budget is spent — the livelock backstop).
        Returns True when the request stays owned by this level."""
        if rid in self._broker_held:
            self._broker_held.discard(rid)
            self.span_tenants[st.tenant].released += 1
            if self.on_broker_displace is not None:
                self.on_broker_displace(rid)
            return False
        self._requeue_or_livelock_drop(st)
        return True

    def _child_displaced(self, g: int, crid: int) -> None:
        """Child g's plane displaced (preemption/churn) a segment this
        level reserved through broker_admit: tear down the composite's
        sibling reservations + cut bandwidth and requeue the request at
        this level (or hand it further up if it was itself broker-held)."""
        rid = self._part_of.get((g, crid))
        if rid is None:
            return
        st = self._span_active.pop(rid, None)
        if st is None:
            self._part_of.pop((g, crid), None)
            return
        self._teardown_span(st, skip=(g, crid))
        self.span_stats["displaced"] += 1
        self.span_tenants[st.tenant].preempted += 1
        if self.tracer.enabled:
            self.tracer.flow_point(rid, "displaced", group=g)
        self._drop_or_requeue(rid, st)
        if self._churn_collector is not None:
            self._churn_collector.append(st)

    def _forget_local(self, g: int, crid: int) -> None:
        rid = self._grid_of.pop((g, crid), None)
        if rid is not None:
            self._local.pop(rid, None)
            if self.on_drop is not None:
                self.on_drop(rid)

    def _displace_spans(self, pred) -> list[SpanningTicket]:
        displaced: list[SpanningTicket] = []
        for rid in [r for r, st in self._span_active.items() if pred(st)]:
            st = self._span_active.pop(rid)
            self._teardown_span(st)
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
        # shared home queue (a cumulative-budget drop leaves its slot empty)
        for st in reversed(displaced):
            self._requeue_or_livelock_drop(st)
        return displaced

    # -- release / churn ------------------------------------------------------

    def release(self, rid: int) -> None:
        if rid in self._broker_held:
            raise KeyError(
                f"rid {rid} is a parent-held broker reservation; it is "
                "released through broker_release by the plane that holds it"
            )
        st = self._span_active.pop(rid, None)
        if st is not None:
            self._teardown_span(st)
            self.span_tenants[st.tenant].released += 1
            if self.tracer.enabled:
                self.tracer.flow_end(rid, "release", outcome="released")
            return
        g, crid = self._local[rid]
        self.children[g].release(crid)  # raises if not active (caller bug)
        del self._local[rid]
        del self._grid_of[(g, crid)]

    def _span_uses_node(self, st: SpanningTicket, v: int) -> bool:
        """Does a top placement touch node ``v`` (this plane's id space) —
        as a gateway of any top hop, or anywhere inside a child segment
        (asked recursively, translated once at the view boundary)?"""
        for (u, w) in st.cuts:
            if v in (u, w):
                return True
        for part in st.parts:
            view = self.views[part.region]
            if not view.contains(v):
                continue
            if self.children[part.region].broker_uses_node(
                    part.tid, int(view.to_local(v))):
                return True
        return False

    def _churn_call(self, fn):
        self._churn_collector = collected = []
        try:
            alive, requeued = fn()
        finally:
            self._churn_collector = None
        return alive, requeued + collected

    def fail_node(self, v: int):
        """Take node ``v`` down: displace top spans touching it, then
        delegate to the owning child (whose own displacement of any
        parent-held segment chains back up through on_broker_displace).
        The child's view invalidation propagates UP the derivation chain
        automatically, so this level's bijection generation bumps too."""
        v = int(v)
        self.node_up[v] = False
        requeued_span = self._displace_spans(
            lambda st: self._span_uses_node(st, v)
        )
        g = int(self.group_of[v])
        alive, requeued = self._churn_call(
            lambda: self.children[g].fail_node(int(self.views[g].to_local(v)))
        )
        return alive, requeued + requeued_span

    def fail_link(self, u: int, v: int):
        u, v = int(u), int(v)
        if self.group_of[u] == self.group_of[v]:
            requeued_span = self._displace_spans(
                lambda st: self.broker_uses_link_span(st, u, v)
            )
            g = int(self.group_of[u])
            view = self.views[g]
            alive, requeued = self._churn_call(
                lambda: self.children[g].fail_link(
                    int(view.to_local(u)), int(view.to_local(v)))
            )
            return alive, requeued + requeued_span
        for e in ((u, v), (v, u)):
            if e in self.cut_link_up:
                self.cut_link_up[e] = False
        requeued_span = self._displace_spans(
            lambda st: any(c in ((u, v), (v, u)) for c in st.cuts)
        )
        return [], requeued_span

    def broker_uses_link_span(self, st: SpanningTicket, u: int, v: int) -> bool:
        """Link-usage predicate for an in-group link, applied to a TOP
        span: only its segment inside that group can ride the link."""
        ga = int(self.group_of[u])
        view = self.views[ga]
        for part in st.parts:
            if part.region != ga:
                continue
            if self.children[ga].broker_uses_link(
                    part.tid, int(view.to_local(u)), int(view.to_local(v))):
                return True
        return False

    def restore_node(self, v: int) -> None:
        v = int(v)
        self.node_up[v] = True
        g = int(self.group_of[v])
        self.children[g].restore_node(int(self.views[g].to_local(v)))

    def restore_link(self, u: int, v: int) -> None:
        u, v = int(u), int(v)
        if self.group_of[u] == self.group_of[v]:
            g = int(self.group_of[u])
            view = self.views[g]
            self.children[g].restore_link(
                int(view.to_local(u)), int(view.to_local(v)))
            return
        for e in ((u, v), (v, u)):
            if e in self.cut_link_up:
                self.cut_link_up[e] = bool(np.isfinite(self.base.lat[e]))

    # -- defragmentation ------------------------------------------------------

    def defrag(self, *, max_extras: Optional[int] = None) -> list:
        """Leaf-local re-optimization, recursively — still no global
        re-solve at any level.  Returns the flattened list of per-leaf
        DefragResults."""
        out: list = []
        for child in self.children:
            out += list(child.defrag(max_extras=max_extras))
        return out

    # -- reporting / invariants ----------------------------------------------

    def leaf_planes(self):
        """Every leaf region's (composed global->leaf view, ControlPlane)
        across the whole tree — the bijection-of-bijection flattened once,
        for cross-level write-through checks and reporting."""
        out = []
        for g, child in enumerate(self.children):
            if isinstance(child, HierarchicalControlPlane):
                for (cv, cp) in child.leaf_planes():
                    out.append((self.views[g].compose(cv), cp))
            else:
                for r, cp in enumerate(child.regions):
                    out.append((self.views[g].compose(child.views[r]), cp))
        return out

    def _kernel_impl_counts(self) -> dict:
        """Per-backend solve counts summed over the whole tree."""
        out: dict[str, int] = {}
        for child in self.children:
            for k, v in child._kernel_impl_counts().items():
                out[k] = out.get(k, 0) + v
        return out

    def _solve_counts(self) -> tuple[int, int]:
        solves = n_sum = 0
        for child in self.children:
            s, n = child._solve_counts()
            solves += s
            n_sum += n
        return solves, n_sum

    def engine_stats(self) -> engine.Stats:
        s = engine.Stats(method=self.method)
        for child in self.children:
            cs = child.engine_stats()
            s.preemptions += cs.preemptions
            s.defrag_rounds += cs.defrag_rounds
            s.solve_ms += cs.solve_ms
            s.overhead_ms += cs.overhead_ms
            s.conflict_resolve_ms += cs.conflict_resolve_ms
            s.stale_batches += cs.stale_batches
            s.gossip_messages += cs.gossip_messages
            s.twopc_messages += cs.twopc_messages
        s.batch_size = self.micro_batch
        s.rounds = self.bus.rounds
        s.gossip_messages += self.bus.messages_sent
        s.twopc_messages += self._twopc_msgs
        s.messages_sent = s.gossip_messages + s.twopc_messages
        solves, n_sum = self._solve_counts()
        if solves:
            s.solve_n = round(n_sum / solves)
        s.kernel_impl = ControlPlane._consensus_impl(
            self._kernel_impl_counts())
        return s

    def metrics_registry(self) -> obs_metrics.MetricsRegistry:
        """Children's registries merged under ``plane=g{g}`` (label paths
        compose per level, e.g. ``g0/r1``), plus this level's gossip, 2PC
        and spanning counters."""
        reg = obs_metrics.MetricsRegistry()
        for g, child in enumerate(self.children):
            reg.merge(child.metrics_registry(), plane=f"g{g}")
        obs_metrics.absorb_gossip_stats(reg, self.bus.gossip_stats())
        obs_metrics.absorb_span_stats(reg, self.span_stats)
        reg.inc("twopc.messages", float(self._twopc_msgs))
        reg.gauge("plane.levels", float(self.levels))
        return reg

    def solve_size_report(self) -> dict:
        per = []
        for i, (cv, cp) in enumerate(self.leaf_planes()):
            st = cp.placer.stats
            per.append({
                "region": i,
                "n_r": cv.n_local,
                "solves": st.solves,
                "mean_solve_n": st.mean_solve_n,
            })
        solves = sum(p["solves"] for p in per)
        nsum = sum(p["solves"] * p["mean_solve_n"] for p in per)
        return {
            "global_n": self.base.n,
            "regions": per,
            "solves": solves,
            "mean_solve_n": (nsum / solves) if solves else 0.0,
            "max_solve_n": max(
                (p["n_r"] for p in per if p["solves"]), default=0),
        }

    def resident_state_report(self) -> dict:
        """Max per-component resident state across the WHOLE tree: this
        level's broker (its boundary gateway id table + one quotient
        entry and one gossip record per direct child) plus every child's
        components, recursively.  The hierarchy's headline claim is that
        this maximum is O(branching + n_leaf), vs the flat plane's
        O(global boundary + R)."""
        gateway_ids = {v for e in self.cut_base for v in e}
        comps = [{
            "component": "broker",
            "id_table": len(gateway_ids),
            "peers": self.B,
            "state": len(gateway_ids) + self.B,
        }]
        for g, child in enumerate(self.children):
            for c in child.resident_state_report()["components"]:
                comps.append({**c, "component": f"child[{g}].{c['component']}"})
        return {
            "components": comps,
            "max_component_state": max(c["state"] for c in comps),
        }

    def coordination_report(self) -> dict:
        return {
            "levels": self.levels,
            "branching": self.B,
            "leaf_regions": self.leaf_regions,
            "fanout": self.bus.fanout,
            "gossip_period": self.gossip_period,
            "gossip": self.bus.gossip_stats(),
            "gossip_messages_total": self.engine_stats().gossip_messages,
            "twopc_messages": self._twopc_msgs,
            "twopc_messages_total": self.engine_stats().twopc_messages,
            "spanning": dict(self.span_stats),
            "cut_edges": len(self.cut_base),
            "children": [c.coordination_report() for c in self.children],
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
        timing = {"solve_ms": 0.0, "overhead_ms": 0.0,
                  "conflict_resolve_ms": 0.0}
        for child in self.children:
            for k, v in child.fairness_report()["timing"].items():
                timing[k] += v
        rep["timing"] = timing
        return rep

    def check_invariants(self) -> None:
        """Every child's invariants recursively, this level's ledger +
        cut conservation + span integrity, and the cross-level
        write-through: leaf residuals and ticket loads lifted through the
        COMPOSED bijections must re-assemble the global base exactly —
        the conservation argument survives nesting."""
        for child in self.children:
            child.check_invariants()
        led = self.conservation()
        assert led["ok"], f"hierarchical ticket conservation violated: {led}"
        # span accounting: single-sited attempts/admitted counters nest
        # strictly (mirrors RegionalControlPlane.check_invariants)
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
                f"top cut bandwidth conservation violated on {e}"
            )
            assert self.cut_residual[e] >= -1e-6, (
                f"negative top cut residual on {e}"
            )
        for rid, st in self._span_active.items():
            assert len(st.parts) == len(st.cuts) + 1, (
                f"top spanning rid {rid}: chain/cut arity mismatch"
            )
            for i, (u, v) in enumerate(st.cuts):
                assert int(self.group_of[u]) == st.parts[i].region
                assert int(self.group_of[v]) == st.parts[i + 1].region
            for part in st.parts:
                child = self.children[part.region]
                assert part.tid in child._span_active, (
                    f"top spanning rid {rid} holds a dead child "
                    f"reservation in group {part.region}"
                )
                assert part.tid in child._broker_held
                assert self._part_of.get((part.region, part.tid)) == rid
                assert part.version <= self.views[part.region].version, (
                    f"top spanning rid {rid}: part minted under a future "
                    "bijection version"
                )
        # cross-level write-through conservation through composed views
        n = self.base.n
        cap_res = np.zeros(n)
        cap_load = np.zeros(n)
        bw_res = np.zeros((n, n))
        bw_load = np.zeros((n, n))
        in_region = np.zeros((n, n), bool)
        for cv, cp in self.leaf_planes():
            cap_res += cv.uncompact_node_vec(cp.placer.cap)
            bw_res += cv.uncompact_link_mat(cp.placer.bw)
            in_region |= cv.uncompact_link_mat(
                np.ones((cv.n_local, cv.n_local), bool))
            for tk in cp.placer.tickets.values():
                for gv, c in cv.uncompact_node_load(tk.node_load).items():
                    cap_load[gv] += c
                for (gu, gv), b in cv.uncompact_edge_load(
                        tk.edge_load).items():
                    bw_load[gu, gv] += b
        assert np.allclose(cap_res + cap_load, self.base.cap, atol=1e-4), (
            "cross-level write-through broke node-capacity conservation"
        )
        assert np.allclose(
            (bw_res + bw_load)[in_region], self.base.bw[in_region], atol=1e-4
        ), "cross-level write-through broke link-bandwidth conservation"
