"""Online multi-request placement service (the paper's dynamicity regime).

Port of ``repro/core/online.py`` (``OnlinePlacer`` and
``AdmissionPipeline``).  Solves run on a CUDA device unless the caller passes
``device="cpu"``.

The paper's setting is *long-running* data-flow applications on a *dynamic*
network: mapping is not a one-shot solve but a continuous service admitting
a stream of requests against **residual** capacity (cf. Benoit et al. 2009,
Eidenbenz & Locher 2016 — concurrent in-network stream processing).

:class:`OnlinePlacer` owns a residual-capacity view of a
:class:`ResourceGraph` and provides:

- ``admit(df)`` / ``release(ticket)`` — placement against the residual
  network with capacity *and* bandwidth commit; rollback-free because a
  mapping is only committed after validating against the residual;
- ``admit_many(dfs)`` — micro-batches concurrent arrivals into a single
  batched DP (``engine.solve_batch_dispatch`` -> ``leastcost_torch_batched``;
  mixed-p requests are padded, see ``core.problem``).  Batched solves share one
  residual snapshot, so each result is re-validated against the *current*
  residual before committing; conflicting requests are re-solved
  individually — optimistic concurrency at micro-batch granularity;
- ``fail_node`` / ``fail_link`` (+ ``restore_*``) — simulated churn.  A
  failure displaces every ticket whose route uses the failed element; the
  placer releases them and re-admits on the degraded residual network
  (highest preemption class first, tids preserved), returning
  ``(remapped new tickets, dropped old tickets)`` — the paper's dynamic
  re-mapping scenario served at throughput;
- service-layer hooks for the multi-tenant control plane
  (``repro_torch.service``): per-ticket ``tenant``/``klass`` metadata,
  ``snapshot``/``restore`` for transactional multi-step mutations,
  ``admit_preempting`` (conservative, strictly class-ordered preemption)
  and ``rekey`` (stable ticket handles across re-mapping/defrag).

Invariant (checked by ``check_invariants``): for every node and link,
``base == residual + sum(ticket loads)`` and ``residual >= 0``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from types import MappingProxyType
from typing import Mapping as MappingT, Optional, Sequence

import numpy as np

from . import engine
from .graph import DataflowPath, Mapping, ResourceGraph, validate_mapping
from .problem import resolve_device
from .residual import ResidualState
from .solution_cache import SolutionCache, request_signature
from ..obs import trace as obs_trace


@dataclasses.dataclass(frozen=True, eq=False)
class Ticket:
    """A committed placement: the handle for ``release`` / churn re-mapping.

    ``node_load`` / ``edge_load`` are read-only views over private defensive
    copies: the placer's conservation invariant
    (``base == residual + sum(ticket loads)``) is computed from these, so a
    caller must not be able to mutate them after commit — item assignment
    raises ``TypeError`` and the dict a caller passed in is never aliased.

    ``tenant`` / ``klass`` are control-plane metadata (``repro_torch.service``):
    the owning tenant and the preemption class.  A ticket may only ever be
    preempted by an admission of *strictly greater* class.
    """

    tid: int
    df: DataflowPath
    mapping: Mapping
    node_load: MappingT[int, float]  # resource node -> committed compute
    edge_load: MappingT[tuple, float]  # (u, v) -> committed bandwidth
    tenant: str = ""
    klass: int = 0

    def __post_init__(self):
        object.__setattr__(self, "node_load", MappingProxyType(dict(self.node_load)))
        object.__setattr__(self, "edge_load", MappingProxyType(dict(self.edge_load)))


@dataclasses.dataclass
class OnlineStats:
    admitted: int = 0
    rejected: int = 0
    released: int = 0
    remapped: int = 0
    dropped: int = 0
    preempted: int = 0  # released to make room for a higher-class admission
    batches: int = 0
    batch_conflicts: int = 0  # re-solved individually after a stale batch solve
    stale_batches: int = 0  # in-flight batches invalidated by churn/restore
    defrag_rounds: int = 0  # global re-optimization passes attempted
    defrag_commits: int = 0  # ... that improved the objective and committed
    solve_ms: float = 0.0  # device solve + reconstruction wall clock
    overhead_ms: float = 0.0  # host validation/commit loops around the solves
    conflict_resolve_ms: float = 0.0  # individual conflict re-solves, end to end
    solves: int = 0  # DP solves issued (a micro-batch counts once)
    solve_n_sum: int = 0  # summed padded node dimension of those solves
    # incremental fast path (SolutionCache): cache-hit admissions commit a
    # revalidated prior mapping with ZERO DP work, so they are deliberately
    # excluded from solve_ms/solves/solve_n_sum — the timing split and
    # mean_solve_n keep describing actual solver work.
    cache_hits: int = 0  # positive hit revalidated against current residual
    cache_misses: int = 0  # signature never seen (or evicted)
    cache_stale: int = 0  # entry found but no longer feasible
    cache_neg_hits: int = 0  # exact-stamp negative entry short-circuited
    warm_solves: int = 0  # bounded correction solves seeded from stale entries
    warm_fallbacks: int = 0  # warm pass placed nothing -> cold re-solve
    # solves per kernel backend ("cuda" / "plain" / native impl name):
    # non-additive engine.Stats fields (kernel_impl) carried as labeled
    # counts instead of last-writer-wins when stats fold across regions
    kernel_impls: dict = dataclasses.field(default_factory=dict)
    # superstep (relaxation-round) histogram per solve mode:
    # {"cold" | "warm": {rounds: solve count}} — the stat that proves the
    # warm-started path converges in fewer supersteps than a cold solve
    supersteps: dict = dataclasses.field(default_factory=dict)

    # solver-work fields preserved across speculative rollbacks (preemption
    # probes, defrag): wall clock was really spent and cache traffic really
    # happened even when the state change is rolled back
    _SOLVE_CARRY = (
        "solve_ms", "overhead_ms", "conflict_resolve_ms", "solves",
        "solve_n_sum", "cache_hits", "cache_misses", "cache_stale",
        "cache_neg_hits", "warm_solves", "warm_fallbacks",
    )

    @property
    def mean_solve_n(self) -> float:
        """Mean padded node dimension per DP solve — the number the
        compacted regional substrate shrinks from the global ``n`` to the
        region-local ``n_r`` (bench_messages solve-size column)."""
        return self.solve_n_sum / self.solves if self.solves else 0.0

    def clone(self) -> "OnlineStats":
        """Deep-enough copy for snapshot/restore: ``dataclasses.replace``
        would alias ``kernel_impls``/``supersteps`` and leak post-snapshot
        mutations through a rollback."""
        c = dataclasses.replace(self)
        c.kernel_impls = dict(self.kernel_impls)
        c.supersteps = {k: dict(v) for k, v in self.supersteps.items()}
        return c

    def solve_accounting(self) -> dict:
        """Capture the solver-work counters before a speculative rollback."""
        acct = {f: getattr(self, f) for f in self._SOLVE_CARRY}
        acct["kernel_impls"] = dict(self.kernel_impls)
        acct["supersteps"] = {k: dict(v) for k, v in self.supersteps.items()}
        return acct

    def restore_solve_accounting(self, acct: dict) -> None:
        """Re-apply counters captured by :meth:`solve_accounting` after a
        ``restore`` — probes did real solver work even when rolled back."""
        for f in self._SOLVE_CARRY:
            setattr(self, f, acct[f])
        self.kernel_impls = dict(acct["kernel_impls"])
        self.supersteps = {k: dict(v) for k, v in acct["supersteps"].items()}


def _edge_loads(df: DataflowPath, mapping: Mapping) -> dict:
    """Bandwidth committed per directed resource link: walk the route; the
    carried dataflow edge advances when the assigned node changes (the same
    walk as ``validate_mapping``)."""
    loads: dict = {}
    assign, route = mapping.assign, mapping.route
    pos = 0
    for u, v in zip(route[:-1], route[1:]):
        while pos + 1 < df.p and assign[pos + 1] == u:
            pos += 1
        loads[(u, v)] = loads.get((u, v), 0.0) + float(df.breq[pos])
    return loads


def _node_loads(df: DataflowPath, mapping: Mapping) -> dict:
    loads: dict = {}
    for i, v in enumerate(mapping.assign):
        loads[v] = loads.get(v, 0.0) + float(df.creq[i])
    return loads


@dataclasses.dataclass(eq=False)
class PendingAdmission:
    """An in-flight micro-batch: solve dispatched, commit deferred.

    Produced by :meth:`OnlinePlacer.dispatch_admit`, consumed exactly once
    by :meth:`OnlinePlacer.commit_admit`.  ``epoch`` is the placer's fence
    value at dispatch: if it moved by commit time (churn, restore, regional
    view invalidation) the dispatched results are discarded and the batch
    re-solves fresh.  The engine handle holds the device tensors it was
    dispatched with (residual updates are out of place), so residual
    mutations between dispatch and commit can never corrupt the
    in-flight solve — only make it *stale*, which commit-time validation
    (optimistic concurrency) or the epoch fence handles.

    ``tag`` is opaque caller context carried dispatch-to-commit (the
    streaming bench stores dispatch-time virtual clock / steady-phase
    flags there).

    With the incremental fast path active, ``plan`` records the dispatch
    classification of each request — ``("hit", mapping)`` (cached mapping
    revalidated at dispatch; commit revalidates again), ``("neg", None)``
    (exact-stamp negative), ``("warm", seed)`` (stale entry seeding a
    bounded correction solve in ``warm_handle``) or ``("cold", None)``
    (full solve in ``handle``).  ``plan is None`` means the cache was off
    for this batch and the commit path is byte-identical to the pre-cache
    code.  ``stamp`` is the (residual version, epoch) pair at dispatch —
    rejections only record negative cache entries if it still matches at
    commit time.
    """

    dfs: list
    metas: list
    handle: Optional[engine.PendingBatchSolve]
    epoch: int
    tag: object = None
    committed: bool = False
    plan: Optional[list] = None
    cold_idx: Optional[list] = None
    warm_idx: Optional[list] = None
    warm_handle: Optional[engine.PendingBatchSolve] = None
    stamp: Optional[tuple] = None


class OnlinePlacer:
    """Residual-capacity placement service over one resource network."""

    def __init__(
        self,
        rg: ResourceGraph,
        *,
        method: str = "leastcost_torch",
        device=None,
        view=None,
        tracer=None,
        cache_enabled: bool = True,
        cache_size: int = 512,
        max_correction_supersteps: int = 4,
        **solve_cfg,
    ):
        """Admissions run through the fused batched DP
        (``kernels/minplus/batched``): the CUDA kernel on a CUDA device, its
        plain version on the CPU — both micro-batched ``admit_many`` and
        single-request ``admit`` re-solves take it.  ``device`` defaults to
        CUDA and raises when there is none; pass ``device="cpu"`` for the
        plain path.  Extra ``solve_cfg`` (e.g. ``kernel_impl``) is forwarded
        to the backend.

        ``cache_enabled`` turns on the two-tier incremental fast path: a
        :class:`~repro_torch.core.solution_cache.SolutionCache` of the last
        committed mapping per request signature (tier 1 — an O(p)
        revalidation replaces the whole DP on repeat shapes), and, for
        stale entries on batched backends, a warm-started DP bounded to
        ``max_correction_supersteps`` relaxation rounds (tier 2) whose
        failures fall back to a full cold solve — admission quality is
        never below the cold path.  The cache is advisory: every hit is
        revalidated against the float64 residual truth before any
        reserve, so it can never over-commit, and ``cache_enabled=False``
        is bit-identical to the pre-cache admission path.  Both knobs ride
        ``**solve_cfg`` through
        ``ControlPlane``/``RegionalControlPlane``/``HierarchicalControlPlane``
        down to every per-region placer, whose caches operate entirely in
        view-local ids.

        ``view`` (a :class:`~repro_torch.core.compact.CompactedView`) makes
        this a *region-local* placer: ``rg`` may be the global graph — it is
        compacted through the view up front, so every piece of state
        (residual arrays and their device tensors, liveness masks, tickets,
        routes) and every DP solve and kernel launch lives at the
        region-local ``n_r``, never the global ``n``.  All dataflows passed
        to ``admit*`` must already be in the view's local id space
        (``view.compact_df``); owners of global id spaces (the regional 2PC
        broker) translate at their boundary and can read the bijection back
        from ``placer.view``.

        ``tracer`` (:class:`repro_torch.obs.trace.Tracer`) records
        solve/commit spans; defaults to the no-op ``NULL`` — tracing is
        purely observational (wall clock only).
        """
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.device = resolve_device(device)
        self.view = view
        if view is not None:
            rg = view.compact_graph(rg) if rg.n == view.n_global else rg
            assert rg.n == view.n_local, "graph does not match the view"
        self.base = rg
        self.method = method
        if method in engine.BATCHED_METHODS:
            solve_cfg = dict(solve_cfg, device=self.device)
        self.solve_cfg = solve_cfg
        self.res = ResidualState(rg, device=self.device)
        self.tickets: dict[int, Ticket] = {}
        self.stats = OnlineStats()
        self._tid = itertools.count()
        self.cache = SolutionCache(cache_size) if cache_enabled else None
        self.max_correction_supersteps = int(max_correction_supersteps)
        self._cache_suspend = 0

    # -- incremental fast path ----------------------------------------------

    @property
    def _cache(self) -> Optional[SolutionCache]:
        """The cache, or None while disabled/suspended (defrag repacks
        suspend it: serving the standing mappings back from cache would
        make the re-optimization a no-op by construction)."""
        if self.cache is None or self._cache_suspend:
            return None
        return self.cache

    @contextlib.contextmanager
    def cache_suspended(self):
        """Bypass the cache (lookups AND fills) inside the block."""
        self._cache_suspend += 1
        try:
            yield
        finally:
            self._cache_suspend -= 1

    def _stamp(self) -> tuple:
        """Exact residual identity: host mutation version + staleness epoch
        (the epoch folds in the CompactedView version, so regional view
        remaps invalidate negative entries automatically)."""
        return (self.res.version, self.epoch)

    # -- residual view ------------------------------------------------------
    # The residual arrays live in ResidualState (host float64 truth +
    # device-resident float32 mirror); these read-only views keep the
    # placer's public surface (tests, regional conservation, examples).

    @property
    def cap(self) -> np.ndarray:
        return self.res.cap

    @property
    def bw(self) -> np.ndarray:
        return self.res.bw

    @property
    def node_up(self) -> np.ndarray:
        return self.res.node_up

    @property
    def link_up(self) -> np.ndarray:
        return self.res.link_up

    @property
    def epoch(self) -> int:
        """Staleness fence for in-flight optimistic batches: residual epoch
        (liveness changes, rollbacks) plus the CompactedView version when
        this is a region-local placer — regional churn invalidates the view,
        which must also invalidate any batch solved on the old compaction."""
        e = self.res.epoch
        if self.view is not None:
            e += self.view.version
        return e

    def residual_graph(self) -> ResourceGraph:
        """The network the next solve sees: committed capacity subtracted,
        failed nodes/links removed (cap 0 / bw 0 / lat INF)."""
        return self.res.residual_graph()

    def utilization(self) -> dict:
        base_cap = float(np.sum(self.base.cap))
        return {
            "nodes_committed": 1.0 - float(np.sum(self.cap)) / max(base_cap, 1e-12),
            "tickets": len(self.tickets),
            "nodes_down": int(np.sum(~self.node_up)),
        }

    # -- commit / release ---------------------------------------------------

    def _commit(self, df: DataflowPath, mapping: Mapping, *,
                tenant: str = "", klass: int = 0) -> Ticket:
        node_load = _node_loads(df, mapping)
        edge_load = _edge_loads(df, mapping)
        self.res.apply_load(node_load, edge_load, -1.0)
        t = Ticket(next(self._tid), df, mapping, node_load, edge_load,
                   tenant=tenant, klass=klass)
        self.tickets[t.tid] = t
        cache = self._cache
        if cache is not None:
            # cache filled only at commit: the entry is a mapping that
            # really held capacity, the strongest reuse candidate
            cache.put(request_signature(df), mapping)
        return t

    def release(self, ticket: Ticket | int, *,
                reason: Optional[str] = "released") -> Ticket:
        """Return a ticket's capacity to the residual.

        ``reason`` selects the stats counter: ``"released"`` (a normal
        departure), ``"preempted"`` (displaced to make room for a
        higher-class admission), or ``None`` (internal bookkeeping, e.g. the
        defrag pass clearing the standing set before the re-solve — counted
        by its own counters instead).
        """
        tid = ticket if isinstance(ticket, int) else ticket.tid
        t = self.tickets.pop(tid)
        self.res.apply_load(t.node_load, t.edge_load, 1.0)
        if reason == "released":
            self.stats.released += 1
        elif reason == "preempted":
            self.stats.preempted += 1
        return t

    # -- snapshot / atomic commit hooks (service-layer defrag + preemption) -

    def snapshot(self) -> dict:
        """Copy-out of the full service state (residuals, liveness, tickets,
        stats).  With :meth:`restore` this brackets speculative multi-step
        mutations — preemption probing, the defrag re-solve — so they either
        commit in full or leave no trace."""
        snap = self.res.snapshot()
        snap["tickets"] = dict(self.tickets)
        snap["stats"] = self.stats.clone()
        return snap

    def restore(self, snap: dict) -> None:
        """Roll back to a :meth:`snapshot` (the snapshot stays reusable).

        The residual epoch advances — it is never rewound — so any batch
        dispatched between snapshot and restore is fenced out: its results
        are *invalidated* at commit, never optimistically applied."""
        self.res.restore(snap)
        self.tickets = dict(snap["tickets"])
        self.stats = snap["stats"].clone()

    def rekey(self, new: Ticket, tid: int) -> Ticket:
        """Re-register a freshly committed ticket under a prior tid, so the
        handle an external holder keeps (control plane, departure timers)
        survives re-mapping and defrag re-placement."""
        kept = dataclasses.replace(new, tid=tid)
        del self.tickets[new.tid]
        self.tickets[tid] = kept
        return kept

    # -- admission ----------------------------------------------------------

    def _admissible(self, df: DataflowPath, mapping: Optional[Mapping],
                    rg: ResourceGraph) -> bool:
        if mapping is None:
            return False
        ok, _why = validate_mapping(rg, df, mapping)
        return ok

    def _note_solve(self, st, *, mode: str = "cold") -> None:
        """Fold one engine.Stats into the lifetime counters, keeping the
        non-additive ``kernel_impl`` as a labeled count and the superstep
        count as a per-mode histogram bucket."""
        self.stats.solve_ms += st.solve_ms
        self.stats.solves += 1
        self.stats.solve_n_sum += st.solve_n
        if st.kernel_impl:
            k = self.stats.kernel_impls
            k[st.kernel_impl] = k.get(st.kernel_impl, 0) + 1
        if mode == "warm":
            self.stats.warm_solves += 1
        if st.rounds:
            bucket = self.stats.supersteps.setdefault(mode, {})
            bucket[int(st.rounds)] = bucket.get(int(st.rounds), 0) + 1

    def admit(self, df: DataflowPath, *, tenant: str = "",
              klass: int = 0) -> Optional[Ticket]:
        """Place one request against the current residual network.

        With the cache enabled this consults tier 1 first: an exact-stamp
        negative short-circuits to rejection (sound — the residual is
        bit-identical to when the deterministic solve last rejected this
        signature), and a positive entry that revalidates against the
        current residual commits with zero DP work (and is deliberately
        NOT counted as a solve).  Anything else falls through to the full
        solve, exactly the pre-cache path."""
        if not (self.node_up[df.src] and self.node_up[df.dst]):
            self.stats.rejected += 1
            return None
        cache = self._cache
        sig = stamp = None
        if cache is not None:
            sig = request_signature(df)
            stamp = self._stamp()
            if cache.negative_hit(sig, stamp):
                self.stats.cache_neg_hits += 1
                self.stats.rejected += 1
                return None
            entry = cache.get(sig)
            if entry is not None:
                if self._admissible(df, entry, self.residual_graph()):
                    self.stats.cache_hits += 1
                    self.stats.admitted += 1
                    return self._commit(df, entry, tenant=tenant, klass=klass)
                self.stats.cache_stale += 1
            else:
                self.stats.cache_misses += 1
        rg = self.residual_graph()
        with self.tracer.span("solve", track="placer", cat="solve"):
            mapping, st = engine.solve(rg, df, method=self.method,
                                       **self.solve_cfg)
        self._note_solve(st)
        if not self._admissible(df, mapping, rg):
            if cache is not None and self._stamp() == stamp:
                cache.put_negative(sig, stamp)
            self.stats.rejected += 1
            return None
        self.stats.admitted += 1
        return self._commit(df, mapping, tenant=tenant, klass=klass)

    def admit_preempting(
        self, df: DataflowPath, *, tenant: str = "", klass: int = 0,
        max_preempt: int = 8, max_displaced_cost: Optional[float] = None,
    ) -> tuple[Optional[Ticket], list[Ticket]]:
        """Admit, displacing strictly-lower-class tickets if necessary.

        Victims are probed lowest class first; within a class, tickets
        loading the *target node* — the node where residual plus
        preemptable load peaks, i.e. where released capacity can
        accumulate into a hole big enough for the request — go first, then
        larger tickets, then newer.  After each release the request is
        re-solved on the freed residual.  If no victim set below ``klass``
        makes the request feasible the whole probe rolls back — preemption
        is *conservative*: capacity is never destroyed on a failed attempt,
        and a class-k ticket is only ever displaced by an admission of
        class > k.  Returns ``(ticket, preempted)``; the caller owns
        re-queueing the preempted work (e.g. through its tenant queue in
        the control plane).

        ``max_displaced_cost`` is the preemption *cost budget*: the summed
        committed compute of the displaced victims may not exceed it.  A
        victim that fits exactly at the budget may still be displaced; the
        first victim that would push past it ends the probe, which then
        rolls back cleanly if the request is still infeasible.
        """
        rejected0 = self.stats.rejected  # a served request is not a rejection
        t = self.admit(df, tenant=tenant, klass=klass)
        if t is not None:
            return t, []
        candidates = [v for v in self.tickets.values() if v.klass < klass]
        if not candidates:
            return None, []
        # concentrate releases where they can open the largest hole
        # (downed nodes can never host the request, whatever their cap)
        potential = np.where(self.node_up, self.cap, -np.inf)
        for v in candidates:
            for node, c in v.node_load.items():
                potential[node] += c
        target = int(np.argmax(potential))
        victims = sorted(
            candidates,
            key=lambda v: (
                v.klass,
                -v.node_load.get(target, 0.0),
                -sum(v.node_load.values()),
                -v.tid,
            ),
        )
        snap = self.snapshot()
        preempted: list[Ticket] = []
        displaced_cost = 0.0
        for v in victims[:max_preempt]:
            vcost = sum(v.node_load.values())
            if (
                max_displaced_cost is not None
                and displaced_cost + vcost > max_displaced_cost + 1e-9
            ):
                break  # over budget: end the probe (rolls back below)
            self.release(v, reason="preempted")
            preempted.append(v)
            displaced_cost += vcost
            t = self.admit(df, tenant=tenant, klass=klass)
            if t is not None:
                # probe rejections along the way are not real rejections
                self.stats.rejected = rejected0
                return t, preempted
        # probes did real solver work: keep the solve accounting across the
        # rollback (state restores, wall-clock and solve counts do not)
        acct = self.stats.solve_accounting()
        self.restore(snap)
        self.stats.restore_solve_accounting(acct)
        return None, []

    def _dispatch_solve(self, dfs: list[DataflowPath], *,
                        warm_starts=None,
                        max_rounds: Optional[int] = None,
                        ) -> engine.PendingBatchSolve:
        """Dispatch a batched solve for ``dfs`` against the current residual.

        On natively-batching backends the DP consumes the device-resident
        residual tensors (no O(n^2) host upload per micro-batch) and the
        batch is bucketed to the next power of two, as in the reference.  Other backends solve synchronously inside the
        returned handle.

        ``warm_starts``/``max_rounds`` run the tier-2 bounded correction
        pass (batched backends only): the DP frontier is seeded from stale
        cached mappings and the relaxation capped at the fuse."""
        cfg = self.solve_cfg
        graph_tensors = None
        if self.method in engine.BATCHED_METHODS:
            cfg = dict(cfg, bucket_batch=True)
            if warm_starts is not None:
                cfg["warm_starts"] = warm_starts
            if max_rounds is not None:
                cfg["max_rounds"] = max_rounds
            graph_tensors = self.res.device_tensors()
        with self.tracer.span("dispatch", track="placer", cat="solve",
                              batch=len(dfs)), \
                self.tracer.annotate("minplus.dispatch"):
            return engine.solve_batch_dispatch(
                self.residual_graph(), list(dfs), method=self.method,
                graph_tensors=graph_tensors, **cfg,
            )

    def dispatch_admit(
        self,
        dfs: list[DataflowPath],
        metas: Optional[Sequence[tuple[str, int]]] = None,
        *,
        tag: object = None,
    ) -> PendingAdmission:
        """Start a micro-batch admission: dispatch the batched DP against a
        residual snapshot and return without waiting.  The device solve runs
        while the caller does host work (typically committing the previous
        batch); :meth:`commit_admit` finishes the admission.

        With the cache enabled each request is classified first (see
        :class:`PendingAdmission`); only the cold subset dispatches the
        full DP and only the stale-entry subset dispatches the bounded
        warm-started correction pass — a batch of pure repeats dispatches
        no solve at all."""
        dfs = list(dfs)
        if metas is None:
            metas = [("", 0)] * len(dfs)
        if not dfs:
            return PendingAdmission([], [], None, self.epoch, tag=tag)
        self.stats.batches += 1
        cache = self._cache
        if cache is None:
            handle = self._dispatch_solve(dfs)
            return PendingAdmission(dfs, list(metas), handle, self.epoch,
                                    tag=tag)
        t0 = time.perf_counter()
        rg = self.residual_graph()
        stamp = self._stamp()
        warm_ok = (self.method in engine.BATCHED_METHODS
                   and self.max_correction_supersteps > 0)
        plan: list[tuple] = []
        for df in dfs:
            sig = request_signature(df)
            if cache.negative_hit(sig, stamp):
                self.stats.cache_neg_hits += 1
                plan.append(("neg", None))
                continue
            entry = cache.get(sig)
            if entry is None:
                self.stats.cache_misses += 1
                plan.append(("cold", None))
                continue
            if (self.node_up[df.src] and self.node_up[df.dst]
                    and self._admissible(df, entry, rg)):
                # provisional hit: commit_admit revalidates against the
                # then-current residual before any reserve
                plan.append(("hit", entry))
                continue
            self.stats.cache_stale += 1
            seed = None
            if warm_ok:
                from .leastcost import warm_seed_from_mapping
                seed = warm_seed_from_mapping(rg, df, entry)
            plan.append(("warm", seed) if seed is not None else ("cold", None))
        cold_idx = [i for i, (k, _) in enumerate(plan) if k == "cold"]
        warm_idx = [i for i, (k, _) in enumerate(plan) if k == "warm"]
        self.stats.overhead_ms += 1e3 * (time.perf_counter() - t0)
        handle = (self._dispatch_solve([dfs[i] for i in cold_idx])
                  if cold_idx else None)
        warm_handle = None
        if warm_idx:
            warm_handle = self._dispatch_solve(
                [dfs[i] for i in warm_idx],
                warm_starts=[plan[i][1] for i in warm_idx],
                max_rounds=self.max_correction_supersteps,
            )
        return PendingAdmission(dfs, list(metas), handle, self.epoch, tag=tag,
                                plan=plan, cold_idx=cold_idx,
                                warm_idx=warm_idx, warm_handle=warm_handle,
                                stamp=stamp)

    def commit_admit(self, pending: PendingAdmission) -> list[Optional[Ticket]]:
        """Finish an in-flight admission: block on the solve (the only
        ``block_until_ready`` point), validate every mapping against the
        *current* residual, and commit.

        Three staleness layers, cheapest first:

        - epoch fence: if churn / restore / view invalidation happened since
          dispatch, the whole in-flight solve is discarded (never committed)
          and the batch re-solves fresh on the degraded network;
        - per-request validation: a mapping invalidated by commits that
          landed after dispatch (earlier in this batch, or — pipelined —
          whole batches) is re-solved individually, the existing
          optimistic-concurrency retry;
        - endpoint liveness re-check, as in the synchronous path.
        """
        assert not pending.committed, "commit_admit consumed twice"
        pending.committed = True
        dfs, metas = pending.dfs, pending.metas
        if not dfs:
            return []
        plan = pending.plan
        if pending.epoch != self.epoch:
            # the network changed shape under the in-flight solve: results
            # are unsalvageable (routes may cross dead elements in ways
            # validation against residuals can't always see) — invalidate,
            # re-solve on the current network.  Cached dispositions are
            # discarded with the rest: dispatch-time hits were validated
            # against a residual whose epoch is gone.
            plan = None
            self.stats.stale_batches += 1
            with self.tracer.span("solve.resolve_stale", track="placer",
                                  cat="solve", batch=len(dfs)):
                mappings, st = self._dispatch_solve(dfs).finalize()
            self._note_solve(st)
        elif plan is None:
            with self.tracer.span("solve.wait", track="placer", cat="solve",
                                  batch=len(dfs)):
                mappings, st = pending.handle.finalize()
            self._note_solve(st)
        else:
            # merge the classified subsets back into request order; only
            # the dispatched subsets count as solves (cache hits are zero
            # DP work and must not deflate the solve timing/size stats)
            mappings = [None] * len(dfs)
            for i, (kind, payload) in enumerate(plan):
                if kind == "hit":
                    mappings[i] = payload
            if pending.handle is not None:
                with self.tracer.span("solve.wait", track="placer",
                                      cat="solve", batch=len(pending.cold_idx)):
                    cold_maps, st = pending.handle.finalize()
                self._note_solve(st)
                for i, m in zip(pending.cold_idx, cold_maps):
                    mappings[i] = m
            if pending.warm_handle is not None:
                with self.tracer.span("solve.warm_wait", track="placer",
                                      cat="solve", batch=len(pending.warm_idx)):
                    warm_maps, wst = pending.warm_handle.finalize()
                self._note_solve(wst, mode="warm")
                for i, m in zip(pending.warm_idx, warm_maps):
                    mappings[i] = m
        cache = self._cache if plan is not None else None
        span = self.tracer.span("validate.commit", track="placer",
                                cat="admit", batch=len(dfs))
        t_host = time.perf_counter()
        conflict_ms = 0.0
        out: list[Optional[Ticket]] = []
        with span:
            current = self.residual_graph()
            for idx, (df, m, (tenant, klass)) in enumerate(
                    zip(dfs, mappings, metas)):
                kind = plan[idx][0] if plan is not None else "cold"
                if (
                    m is not None
                    and self.node_up[df.src]
                    and self.node_up[df.dst]
                    and self._admissible(df, m, current)
                ):
                    if kind == "hit":
                        self.stats.cache_hits += 1
                    self.stats.admitted += 1
                    out.append(self._commit(df, m, tenant=tenant, klass=klass))
                    current = self.residual_graph()
                elif m is not None:
                    # stale snapshot (a commit since dispatch took the
                    # capacity) — optimistic-concurrency retry, individually.
                    # A dispatch-time hit invalidated by an earlier commit in
                    # this batch lands here too; the retry's own cache lookup
                    # counts it as stale, so it is not a batch conflict (no
                    # solver work was wasted on it).
                    if kind != "hit":
                        self.stats.batch_conflicts += 1
                    t0 = time.perf_counter()
                    with self.tracer.span("conflict.resolve", track="placer",
                                          cat="admit"):
                        t = self.admit(df, tenant=tenant, klass=klass)
                    conflict_ms += 1e3 * (time.perf_counter() - t0)
                    out.append(t)
                    if t is not None:
                        current = self.residual_graph()
                elif kind == "warm":
                    # the bounded correction pass placed nothing — the fuse:
                    # fall back to a full cold re-solve so admission quality
                    # is never below the cold path
                    self.stats.warm_fallbacks += 1
                    t0 = time.perf_counter()
                    with self.tracer.span("warm.fallback", track="placer",
                                          cat="admit"):
                        t = self.admit(df, tenant=tenant, klass=klass)
                    conflict_ms += 1e3 * (time.perf_counter() - t0)
                    out.append(t)
                    if t is not None:
                        current = self.residual_graph()
                else:
                    self.stats.rejected += 1
                    if (cache is not None and kind == "cold"
                            and self._stamp() == pending.stamp):
                        # the residual is bit-identical to the dispatch
                        # snapshot the solve rejected against: an exact-
                        # stamp negative is sound
                        cache.put_negative(request_signature(df),
                                           pending.stamp)
                    out.append(None)
        self.stats.conflict_resolve_ms += conflict_ms
        self.stats.overhead_ms += 1e3 * (time.perf_counter() - t_host) - conflict_ms
        return out

    def admit_many(
        self,
        dfs: list[DataflowPath],
        metas: Optional[Sequence[tuple[str, int]]] = None,
    ) -> list[Optional[Ticket]]:
        """Micro-batch concurrent arrivals into one batched DP solve.

        All requests solve against one residual snapshot; commits are
        serialized, and any mapping invalidated by an earlier commit in the
        same batch is re-solved individually on the fresh residual.

        Exactly :meth:`dispatch_admit` immediately followed by
        :meth:`commit_admit` — the depth-1 degenerate of the admission
        pipeline, so the synchronous and pipelined paths cannot drift.
        """
        if not dfs:
            return []
        return self.commit_admit(self.dispatch_admit(dfs, metas))

    def warmup(self, *, max_batch: int = 32, p: int = 5) -> int:
        """Build/load the kernel and touch every shape the admission path
        will hit: the single-request DP (conflict re-solves / churn
        re-admissions) and every power-of-two batch bucket up to
        ``max_batch``, cold and warm-seeded, for requests of length ``p``.
        Returns the largest warmed bucket (0 for a backend without a device
        path).  Solves run on the residual network but commit nothing and
        touch no stats — the kernel build and first-launch costs move here
        instead of polluting the first admissions' latency.
        """
        if self.method not in engine.BATCHED_METHODS:
            return 0
        rg = self.residual_graph()
        warm = DataflowPath.make(
            np.zeros(p, np.float32), np.zeros(p - 1, np.float32),
            src=0, dst=0,
        )
        engine.solve(rg, warm, method=self.method, **self.solve_cfg)
        warm_max = 1 << max(1, int(max_batch - 1).bit_length())
        # tier-2 correction solves (warm frontier + the bounded-rounds fuse)
        seed = None
        if self.cache is not None and self.max_correction_supersteps > 0:
            seed = {
                "v": np.zeros(4, np.int32),
                "j": np.arange(1, 5, dtype=np.int32).clip(max=p),
                "cost": np.zeros(4, np.float32),
                "pv": np.zeros(4, np.int32),
                "pj": np.arange(0, 4, dtype=np.int32).clip(max=p - 1),
            }
        b = 1
        while b <= warm_max:
            engine.solve_batch(rg, [warm] * b, method=self.method,
                               bucket_batch=True, **self.solve_cfg)
            if seed is not None:
                engine.solve_batch(
                    rg, [warm] * b, method=self.method, bucket_batch=True,
                    warm_starts=[seed] * b,
                    max_rounds=self.max_correction_supersteps,
                    **self.solve_cfg)
            b *= 2
        self.res.device_tensors()  # materialize the device mirror
        return warm_max

    # -- churn --------------------------------------------------------------

    def _displaced(self, pred) -> list[Ticket]:
        return [t for t in self.tickets.values() if pred(t)]

    def _remap(self, displaced: list[Ticket]) -> tuple[list[Ticket], list[Ticket]]:
        """Release the displaced tickets and re-admit them on the degraded
        residual, highest preemption class first (a class never waits behind
        a lower one for the post-failure capacity).  Re-admitted tickets keep
        their original ``tid`` (:meth:`rekey`), so handles held outside the
        placer — control-plane records, departure timers — stay valid across
        re-mapping.  Returns ``(remapped new tickets, dropped old tickets)``;
        dropped entries carry their ``df``/``tenant``/``klass`` so the caller
        can re-queue or escalate them.
        """
        displaced = sorted(displaced, key=lambda t: (-t.klass, t.tid))
        for t in displaced:
            self.release(t, reason=None)
        remapped, dropped = [], []
        tickets = self.admit_many(
            [t.df for t in displaced],
            metas=[(t.tenant, t.klass) for t in displaced],
        )
        for t, nt in zip(displaced, tickets):
            if nt is None:
                dropped.append(t)
                self.stats.dropped += 1
            else:
                remapped.append(self.rekey(nt, t.tid))
                self.stats.remapped += 1
        return remapped, dropped

    def fail_node(self, v: int) -> tuple[list[Ticket], list[Ticket]]:
        """Take node ``v`` down; re-map every placement routed through it.
        Bumps the residual epoch: in-flight optimistic batches are fenced
        out and will re-solve on the degraded network at commit."""
        self.res.set_node_up(v, False)
        return self._remap(self._displaced(lambda t: v in t.mapping.route))

    def fail_link(self, u: int, v: int) -> tuple[list[Ticket], list[Ticket]]:
        """Take the (symmetric) link down; re-map placements using it."""
        self.res.set_link_up(u, v, False)
        return self._remap(
            self._displaced(
                lambda t: (u, v) in t.edge_load or (v, u) in t.edge_load
            )
        )

    def restore_node(self, v: int) -> None:
        self.res.set_node_up(v, True)

    def restore_link(self, u: int, v: int) -> None:
        up = np.isfinite(self.base.lat[u, v])
        self.res.set_link_up(u, v, bool(up))

    # -- invariants ---------------------------------------------------------

    def check_invariants(self, atol: float = 1e-4) -> None:
        """base == residual + sum(ticket loads), residual >= 0, everywhere."""
        n = self.base.n
        cap_used = np.zeros(n)
        bw_used = np.zeros((n, n))
        for t in self.tickets.values():
            for v, c in t.node_load.items():
                cap_used[v] += c
            for (u, v), b in t.edge_load.items():
                bw_used[u, v] += b
        assert np.allclose(self.cap + cap_used, self.base.cap, atol=atol), (
            "node capacity conservation violated"
        )
        assert np.allclose(self.bw + bw_used, self.base.bw, atol=atol), (
            "link bandwidth conservation violated"
        )
        assert np.all(self.cap >= -atol), "negative residual capacity"
        assert np.all(self.bw >= -atol), "negative residual bandwidth"


class AdmissionPipeline:
    """Depth-bounded cross-batch admission pipeline over one placer.

    ``push(dfs)`` dispatches a new micro-batch solve and commits the oldest
    in-flight batch(es) once the window is full, so batch k+1's device DP
    runs while batch k's results validate and commit on the host.  With
    ``depth=1`` every push commits immediately — structurally identical to
    :meth:`OnlinePlacer.admit_many` (the bit-identity the fuzz suite
    enforces).  Deeper windows trade result staleness (more optimistic
    conflicts, re-solved individually at commit) for dead-time: the host
    never waits on a solve that hasn't had a full batch-interval to finish.

    Commit order is FIFO — admission outcomes depend only on the order
    batches *commit*, which matches the order they were pushed.
    """

    def __init__(self, placer: OnlinePlacer, depth: int = 1):
        self.placer = placer
        self.depth = max(1, int(depth))
        self._q: collections.deque[PendingAdmission] = collections.deque()

    @property
    def in_flight(self) -> int:
        return len(self._q)

    def push(
        self,
        dfs: list[DataflowPath],
        metas: Optional[Sequence[tuple[str, int]]] = None,
        *,
        tag: object = None,
    ) -> list[tuple[PendingAdmission, list[Optional[Ticket]]]]:
        """Dispatch ``dfs``; commit whatever the window forces out.  Returns
        ``(pending, tickets)`` for each batch committed by this call — the
        pending carries the caller's dispatch-time ``tag``."""
        if dfs:
            tr = self.placer.tracer
            if tr.enabled:
                tr.instant("pipeline.push", track="placer", cat="pipeline",
                           batch=len(dfs), in_flight=len(self._q))
            self._q.append(self.placer.dispatch_admit(dfs, metas, tag=tag))
        out = []
        while len(self._q) >= self.depth:
            out.append(self._commit_oldest())
        return out

    def flush(self) -> list[tuple[PendingAdmission, list[Optional[Ticket]]]]:
        """Commit every in-flight batch (end of stream / barrier)."""
        out = []
        while self._q:
            out.append(self._commit_oldest())
        return out

    def _commit_oldest(self):
        pending = self._q.popleft()
        return pending, self.placer.commit_admit(pending)
