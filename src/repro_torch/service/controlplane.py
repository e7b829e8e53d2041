"""Multi-tenant placement control plane over :class:`OnlinePlacer`.

Port of ``repro/service/controlplane.py``: ``method`` defaults to
``leastcost_torch`` and ``device=`` (CUDA unless the caller passes
``device="cpu"``) reaches the placer in place of ``use_kernel``.

The layer between the online placer and the serving front end.  Tenants
register with a weight (and optional budget); arrivals queue per tenant
(class-major, FIFO within a class) and :meth:`ControlPlane.pump` drains the
queues into ``admit_many`` micro-batches under the weighted max-min
:class:`FairSharePolicy` — under overload, residual capacity divides by
weight instead of by arrival order.
Every request carries a preemption class; rejected high-class admissions
and churn re-mapping may displace strictly-lower-class tickets
(:meth:`OnlinePlacer.admit_preempting`), and preempted work re-enters
through its tenant queue, never silently dropped.  A background
:meth:`defrag` pass re-solves the whole standing set as one batched kernel
solve and commits atomically only on improvement (``service.defrag``).

Request lifecycle (conservation-checked by the fuzz tests)::

    submit -> queued -> active -> released
                 ^         |
                 |         +-- preempted / displaced-by-failure (requeued)
                 +-- retried (admission failed, attempts left)
    queued/active -> dropped (attempts exhausted, or infeasible)

``conservation()`` returns the ledger; ``submitted == queued + active +
released + dropped`` holds after every public call.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Optional

import numpy as np

from ..core import engine
from ..core.graph import DataflowPath, ResourceGraph
from ..core.online import OnlinePlacer, Ticket
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import defrag as defrag_mod
from .policy import FairSharePolicy, TenantConfig, may_preempt


@dataclasses.dataclass(eq=False)
class Request:
    """One submitted placement request (``eq=False``: identity semantics so
    deque removal and bookkeeping never compare numpy payloads)."""

    rid: int
    tenant: str
    df: DataflowPath
    klass: int = 0
    attempts: int = 0  # failed placement tries this episode (reset on displace)
    cum_attempts: int = 0  # lifetime tries + displacements (never reset)
    creq_sum: float = 0.0

    def __post_init__(self):
        self.creq_sum = float(np.sum(self.df.creq))


@dataclasses.dataclass
class TenantState:
    cfg: TenantConfig
    queue: collections.deque = dataclasses.field(
        default_factory=collections.deque
    )
    submitted: int = 0
    admitted: int = 0
    released: int = 0
    dropped: int = 0
    preempted: int = 0  # times this tenant's work was displaced (then requeued)


class ControlPlane:
    """Fair admission + preemption classes + background defrag.

    ``ControlPlane(rg, regions=R)`` with ``R > 1`` constructs the
    decentralized regional plane instead (``service.regions``): the network
    is sharded into R regions, each with its own queues/residual/placer,
    coordinated only by gossiped share estimates and a bounded two-phase
    commit for region-spanning dataflows.  ``R = 1`` (the default) is this
    centralized plane — the bit-identical degenerate case.
    """

    def __new__(cls, rg=None, *args, regions: int = 1, **kwargs):
        levels = kwargs.get("levels")
        if levels is not None and int(levels) < 1:
            raise ValueError(f"levels={levels} must be >= 1")
        if cls is ControlPlane and levels is not None and int(levels) > 1:
            from .hierarchy import HierarchicalControlPlane

            # nested planes: levels >= 2 builds the hierarchy regardless of
            # how the leaf partition is given (regions=, region_of=, or
            # branching=); contradictions fail fast in resolve_nesting.
            return HierarchicalControlPlane(
                rg,
                regions=int(regions) if int(regions) > 1 else None,
                **kwargs,
            )
        regional = (
            int(regions) > 1
            or kwargs.get("region_of") is not None
            or levels is not None  # levels=1 asks for the flat regional plane
            or kwargs.get("branching") is not None  # fails fast there
        )
        if cls is ControlPlane and regional:
            from .regions import RegionalControlPlane

            # not a ControlPlane subclass, so __init__ below is not re-run.
            # A caller-pinned region_of alone implies the regional plane
            # (its region count comes from the assignment); an explicit
            # regions= is cross-checked against it there.
            return RegionalControlPlane(
                rg,
                regions=int(regions) if int(regions) > 1 else None,
                **kwargs,
            )
        return super().__new__(cls)

    def __init__(
        self,
        rg: ResourceGraph,
        *,
        regions: int = 1,
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
        view=None,
        tracer=None,
        **solve_cfg,
    ):
        """``device`` is where the plane's placer keeps its residual tensors
        and runs its solves: CUDA by default (raising when there is none),
        ``device="cpu"`` for the plain path.  ``kernel_impl`` rides
        ``**solve_cfg`` to the solver.

        ``view`` (a :class:`~repro_torch.core.compact.CompactedView`) makes
        this a *region-local* plane: the placer compacts ``rg`` through it
        so all state and every solve is sized to the view's ``n_r``; all
        submitted dataflows must already be in the view's local id space
        (the regional broker translates at its boundary).

        ``pipeline_depth`` bounds the admission pipeline: each
        :meth:`pump` round *dispatches* its micro-batch solve immediately
        but only *commits* once the in-flight window reaches the depth, so
        batch k+1's device DP overlaps batch k's validation/commit.  Depth
        1 (default) is the synchronous path, bit for bit.  In-flight
        batches persist across ``pump`` calls (``conservation()`` counts
        them); :meth:`flush` forces them all to commit.

        ``tracer`` (:class:`repro_torch.obs.Tracer`) records request-lifecycle
        flow events (submit/dispatch/admit/reject/preempt/release) and
        pump/solve/defrag spans; defaults to the no-op
        :data:`repro_torch.obs.NULL`.

        The incremental-fast-path knobs (``cache_enabled`` /
        ``cache_size`` / ``max_correction_supersteps``) ride
        ``**solve_cfg`` into the plane's :class:`OnlinePlacer`, as they
        do for every plane class — the placer consumes them as named
        parameters, so they never leak into the solver backend."""
        assert int(regions) <= 1, "regions > 1 is dispatched in __new__"
        # nesting kwargs are facade-dispatched in __new__; reaching this
        # body with either set means a direct centralized construction
        # that would otherwise silently ignore them
        if levels is not None and int(levels) != 1:
            raise ValueError(
                f"levels={levels}: the centralized ControlPlane is "
                "single-level; build a hierarchy with ControlPlane(rg, "
                "levels=...) on the facade"
            )
        if branching is not None:
            raise ValueError(
                f"branching={branching} requires a hierarchical plane "
                "(levels >= 2)"
            )
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.placer = OnlinePlacer(
            rg, method=method, device=device, view=view,
            tracer=self.tracer, **solve_cfg
        )
        self.policy = policy or FairSharePolicy()
        self.micro_batch = int(micro_batch)
        self.max_attempts = int(max_attempts)
        self.preempt = bool(preempt)
        self.preempt_budget = preempt_budget
        self.pipeline_depth = max(1, int(pipeline_depth))
        # (picked requests, PendingAdmission) windows dispatched but not yet
        # committed — FIFO, survives across pump calls
        self._inflight: collections.deque = collections.deque()
        self.tenants: dict[str, TenantState] = {}
        self.active: dict[int, tuple[Request, Ticket]] = {}  # by rid
        self._rid_of_tid: dict[int, int] = {}
        self._rid = itertools.count()
        # victims preempted here that this plane does not own (e.g. spanning
        # segments reserved by the regional broker) are handed to this hook
        # so their composite placements can be reconciled
        self.on_foreign_preempt: Optional[callable] = None
        # called with the Request whenever this plane drops it (attempts
        # exhausted) — lets an owner of external rid maps (the regional
        # broker) forget its bookkeeping for terminal requests
        self.on_drop: Optional[callable] = None

    # -- registration / submission ------------------------------------------

    def register_tenant(
        self, name: str, *, weight: float = 1.0,
        budget: Optional[float] = None,
    ) -> TenantConfig:
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        cfg = TenantConfig(name, weight=weight, budget=budget)
        self.tenants[name] = TenantState(cfg)
        return cfg

    @staticmethod
    def _enqueue(queue: collections.deque, r: Request, *,
                 front_of_class: bool = False) -> None:
        """Class-major insertion: higher classes drain first, FIFO within a
        class.  ``front_of_class`` re-inserts ahead of the request's own
        class band (preempted/displaced work resumes before new arrivals of
        its class)."""
        if front_of_class:
            i = next((i for i, x in enumerate(queue) if x.klass <= r.klass),
                     len(queue))
        else:
            i = next((i for i, x in enumerate(queue) if x.klass < r.klass),
                     len(queue))
        queue.insert(i, r)

    def submit(self, tenant: str, df: DataflowPath, *, klass: int = 0) -> int:
        """Queue a request; returns its rid.  Nothing is placed until
        :meth:`pump` drains the queues under the fairness policy."""
        st = self.tenants[tenant]  # KeyError for unregistered: caller bug
        r = Request(next(self._rid), tenant, df, klass=klass)
        self._enqueue(st.queue, r)
        st.submitted += 1
        if self.tracer.enabled:
            self.tracer.flow_begin(r.rid, "submit", tenant=tenant,
                                   klass=klass, p=int(df.p))
        return r.rid

    # -- live accounting -----------------------------------------------------

    def committed_capacity(self) -> dict[str, float]:
        """Live committed compute per tenant (from the active tickets, the
        ground truth — never a counter that could drift)."""
        held = {t: 0.0 for t in self.tenants}
        for req, _ in self.active.values():
            held[req.tenant] += req.creq_sum
        return held

    def queued_demand(self) -> dict[str, float]:
        return {
            t: sum(r.creq_sum for r in st.queue)
            for t, st in self.tenants.items()
        }

    def active_ids(self) -> list[int]:
        """Sorted rids of the currently active (admitted, unreleased)
        requests — the handles :meth:`release` accepts.  Mirrored by the
        regional plane so callers can stay plane-agnostic."""
        return sorted(self.active)

    def rid_of(self, ticket: Ticket) -> Optional[int]:
        """The request id an admitted ticket belongs to (stable across
        re-mapping and defrag, which preserve tids)."""
        return self._rid_of_tid.get(ticket.tid)

    def conservation(self) -> dict[str, int]:
        """The ticket ledger; ``ok`` iff every submitted request is in
        exactly one terminal/live state.  ``in_flight`` counts requests
        popped from their queues into a dispatched-but-uncommitted pipeline
        window — a live state of its own until the window commits."""
        queued = sum(len(st.queue) for st in self.tenants.values())
        released = sum(st.released for st in self.tenants.values())
        dropped = sum(st.dropped for st in self.tenants.values())
        submitted = sum(st.submitted for st in self.tenants.values())
        in_flight = sum(len(picked) for picked, _ in self._inflight)
        return {
            "submitted": submitted,
            "queued": queued,
            "in_flight": in_flight,
            "active": len(self.active),
            "released": released,
            "dropped": dropped,
            "ok": submitted
            == queued + in_flight + len(self.active) + released + dropped,
        }

    # -- admission -----------------------------------------------------------

    def _activate(self, req: Request, ticket: Ticket) -> None:
        self.active[req.rid] = (req, ticket)
        self._rid_of_tid[ticket.tid] = req.rid
        self.tenants[req.tenant].admitted += 1

    def _deactivate(self, rid: int) -> tuple[Request, Ticket]:
        req, ticket = self.active.pop(rid)
        self._rid_of_tid.pop(ticket.tid, None)
        return req, ticket

    def _requeue(self, req: Request, *, front: bool = True) -> None:
        self._enqueue(self.tenants[req.tenant].queue, req,
                      front_of_class=front)

    def _drop(self, req: Request) -> None:
        self.tenants[req.tenant].dropped += 1
        if self.tracer.enabled:
            self.tracer.flow_end(req.rid, "drop", outcome="dropped",
                                 attempts=req.attempts)
        if self.on_drop is not None:
            self.on_drop(req)

    def preempt_reclaim(self, victims: list[Ticket]) -> list[Ticket]:
        """Re-queue displaced victims this plane owns: each re-enters its
        tenant queue at the front of its class band (accounted, never
        dropped).  Victims whose tid is unknown here — e.g. segments of a
        region-spanning placement reserved directly by the regional broker —
        are returned for the caller to reconcile."""
        leftovers: list[Ticket] = []
        owned: list[Request] = []
        for v in victims:
            vrid = self._rid_of_tid.get(v.tid)
            if vrid is None:
                leftovers.append(v)
                continue
            vreq, _ = self._deactivate(vrid)
            vreq.attempts = 0
            self.tenants[vreq.tenant].preempted += 1
            if self.tracer.enabled:
                self.tracer.flow_point(vreq.rid, "preempt",
                                       tenant=vreq.tenant, klass=vreq.klass)
            owned.append(vreq)
        # front-of-class insertion reverses a batch; requeue back-to-front
        # so displaced work keeps its relative (FIFO-within-class) order
        for vreq in reversed(owned):
            self._requeue(vreq, front=True)
        return leftovers

    def _try_preempt(self, req: Request) -> Optional[Ticket]:
        """Attempt class-ordered preemptive admission for ``req``; on
        success, every displaced victim re-enters its tenant queue at the
        front of its class band (accounted, never dropped)."""
        if not self.preempt or not any(
            may_preempt(t.klass, req.klass)
            for t in self.placer.tickets.values()
        ):
            return None
        ticket, victims = self.placer.admit_preempting(
            req.df, tenant=req.tenant, klass=req.klass,
            max_displaced_cost=self.preempt_budget,
        )
        if ticket is None:
            return None
        leftovers = self.preempt_reclaim(victims)
        if leftovers and self.on_foreign_preempt is not None:
            self.on_foreign_preempt(leftovers)
        self._activate(req, ticket)
        return ticket

    def _handle_reject(self, req: Request) -> Optional[Ticket]:
        """A drained request the placer could not fit: try class preemption,
        else retry later (bounded) or drop."""
        req.attempts += 1
        if self.tracer.enabled:
            self.tracer.flow_point(req.rid, "reject", attempts=req.attempts)
        ticket = self._try_preempt(req)
        if ticket is not None:
            return ticket
        if req.attempts >= self.max_attempts:
            self._drop(req)
        else:
            self._requeue(req, front=True)
        return None

    def pump(
        self, *, rounds: int = 1,
        extra_committed: Optional[dict[str, float]] = None,
    ) -> list[Ticket]:
        """Drain the tenant queues under the fairness policy.

        Each round selects up to ``micro_batch`` eligible queue heads
        (weighted max-min over live committed compute), pops them, and
        admits them as ONE ``admit_many`` micro-batch — the batched kernel
        serves the whole drain.  Rejections go through preemption /
        retry / drop handling.  Returns the tickets admitted.

        ``extra_committed`` (tenant -> compute) is added to the live local
        accounting before the fairness selection: the regional plane passes
        each region the *gossiped estimate* of what every tenant holds in
        the other regions, so the drain enforces estimated global shares
        without any global view.  Admission itself still validates against
        this plane's own residual only — stale estimates can skew the drain
        order, never over-commit capacity.

        With ``pipeline_depth > 1`` each round dispatches its micro-batch
        and commits only the rounds the window forces out; the rest stay
        in flight (returned by a later ``pump`` or :meth:`flush`).  The
        fairness selection then reads committed capacity that may lag by
        up to ``depth - 1`` windows — the same staleness-for-latency trade
        the gossiped regional shares make, and with the same safety net:
        the drain order can skew, admission never over-commits.
        """
        admitted: list[Ticket] = []
        cfgs = {t: st.cfg for t, st in self.tenants.items()}
        for _ in range(rounds):
            with self.tracer.span("pump.round", track="plane", cat="pump"):
                queues = {t: st.queue for t, st in self.tenants.items()}
                committed = self.committed_capacity()
                for t, c in (extra_committed or {}).items():
                    if t in committed:
                        committed[t] += float(c)
                picked = self.policy.select(
                    cfgs, queues, committed, self.micro_batch
                )
                if not picked:
                    break
                for r in picked:  # selection reads per-tenant heads in order
                    q = self.tenants[r.tenant].queue
                    assert q[0] is r, "policy must select queue heads in order"
                    q.popleft()
                    if self.tracer.enabled:
                        self.tracer.flow_point(r.rid, "dispatch",
                                               attempts=r.attempts)
                pending = self.placer.dispatch_admit(
                    [r.df for r in picked],
                    metas=[(r.tenant, r.klass) for r in picked],
                )
                self._inflight.append((picked, pending))
                while len(self._inflight) >= self.pipeline_depth:
                    admitted.extend(self._commit_oldest())
        # a later preemption in the same pump may have displaced an earlier
        # admission: hand back only handles that are still live
        return [t for t in admitted if self.placer.tickets.get(t.tid) is t]

    def _commit_oldest(self) -> list[Ticket]:
        """Commit the oldest in-flight window: block on its solve, then
        activate / reject-handle each request exactly as the synchronous
        path does."""
        picked, pending = self._inflight.popleft()
        tickets = self.placer.commit_admit(pending)
        # activate every successful admission BEFORE any reject handling:
        # a rejected request's preemption may displace a sibling from this
        # very window, and reclaim can only requeue victims it finds in
        # the registry — activating afterwards would resurrect a ticket
        # the placer already released (stale-registry leak)
        out: list[Ticket] = []
        for r, t in zip(picked, tickets):
            if t is not None:
                self._activate(r, t)
                if self.tracer.enabled:
                    self.tracer.flow_point(r.rid, "admit", tid=t.tid)
                out.append(t)
        for r, t in zip(picked, tickets):
            if t is None:
                t2 = self._handle_reject(r)
                if t2 is not None:
                    out.append(t2)
        return out

    def flush(self) -> list[Ticket]:
        """Commit every in-flight pipeline window (barrier).  Returns the
        still-live tickets it admitted.  Call before anything that needs
        the full picture of committed state — defrag does this itself."""
        admitted: list[Ticket] = []
        while self._inflight:
            admitted.extend(self._commit_oldest())
        return [t for t in admitted if self.placer.tickets.get(t.tid) is t]

    # -- release / churn ------------------------------------------------------

    def release(self, rid: int) -> None:
        req, ticket = self._deactivate(rid)
        self.placer.release(ticket)
        self.tenants[req.tenant].released += 1
        if self.tracer.enabled:
            self.tracer.flow_end(rid, "release", outcome="released")

    def _reconcile_churn(
        self, remapped: list[Ticket], dropped: list[Ticket]
    ) -> tuple[list[Ticket], list[Ticket]]:
        """After ``fail_*``: remapped tickets kept their tid (update the
        handle); dropped ones re-enter their tenant queue — displacement by
        the environment is handled exactly like preemption, and a dropped
        high-class request may immediately preempt lower-class survivors
        (which are requeued in turn).  Returns ``(alive, requeued)``:
        every ticket still active after reconciliation — in-place remaps
        (tid preserved) plus preemptive rescues (new tid) — and the old
        tickets of requests that went back to a queue, so a caller can
        attach lifecycle (departure timers) to exactly the live set."""
        for nt in remapped:
            rid = self._rid_of_tid.get(nt.tid)
            if rid is not None:
                req, _ = self.active[rid]
                self.active[rid] = (req, nt)
        # a dropped ticket with no local rid is foreign work reserved here
        # directly (a spanning segment owned by the regional broker): hand
        # it to the owner BEFORE the rescue pass, so the broker can tear
        # down the rest of the composite placement instead of leaking its
        # sibling reservations (the partial-teardown regression)
        foreign = [t for t in dropped if self._rid_of_tid.get(t.tid) is None]
        if foreign and self.on_foreign_preempt is not None:
            self.on_foreign_preempt(foreign)
        rescued: list[Ticket] = []
        requeued: list[Ticket] = []
        to_requeue: list[Request] = []
        for old in dropped:
            rid = self._rid_of_tid.get(old.tid)
            if rid is None:
                continue
            req, _ = self._deactivate(rid)
            req.attempts = 0
            self.tenants[req.tenant].preempted += 1
            t = self._try_preempt(req)
            if t is None:
                to_requeue.append(req)
                requeued.append(old)
            else:
                rescued.append(t)
        # back-to-front so the batch keeps FIFO-within-class order
        for req in reversed(to_requeue):
            self._requeue(req, front=True)
        alive = [
            t for t in remapped + rescued
            if self.placer.tickets.get(t.tid) is t  # rescue may preempt one
        ]
        return alive, requeued

    def fail_node(self, v: int) -> tuple[list[Ticket], list[Ticket]]:
        """Take node ``v`` down.  Returns ``(alive, requeued)``: the
        tickets still active after re-mapping and preemptive rescue, and
        the old tickets of displaced requests now waiting in their tenant
        queues (see :meth:`_reconcile_churn`)."""
        return self._reconcile_churn(*self.placer.fail_node(v))

    def fail_link(self, u: int, v: int) -> tuple[list[Ticket], list[Ticket]]:
        """Take the (symmetric) link down; same contract as
        :meth:`fail_node`."""
        return self._reconcile_churn(*self.placer.fail_link(u, v))

    def restore_node(self, v: int) -> None:
        self.placer.restore_node(v)

    def restore_link(self, u: int, v: int) -> None:
        self.placer.restore_link(u, v)

    # -- defragmentation ------------------------------------------------------

    def _fair_queue_heads(self, limit: Optional[int]) -> list[Request]:
        """Queued requests in defrag retry order: class-major, then the
        water-filling drain order (most under-served tenant first), FIFO
        within a tenant.  Tenant budgets stay hard caps: requests that
        would push a tenant past its budget are left queued."""
        held = self.committed_capacity()
        order: list[Request] = []
        heads = {
            t: list(st.queue) for t, st in self.tenants.items() if st.queue
        }
        virt = dict(held)
        while heads:
            t = min(
                heads,
                key=lambda t: (virt[t] / self.tenants[t].cfg.weight, t),
            )
            r = heads[t].pop(0)
            if not heads[t]:
                del heads[t]
            budget = self.tenants[t].cfg.budget
            if budget is not None and virt[t] + r.creq_sum > budget + 1e-9:
                continue
            virt[t] += r.creq_sum
            order.append(r)
        order.sort(key=lambda r: -r.klass)  # stable: keeps fair order per class
        if limit is not None:
            order = order[:limit]
        return order

    def defrag(self, *, max_extras: Optional[int] = None) -> defrag_mod.DefragResult:
        """Global re-optimization of the standing set (``service.defrag``),
        retrying queued requests on the re-packed network.  Atomic: on a
        non-improving pass nothing changes."""
        # the re-pack must see the whole standing set, and its
        # snapshot/restore would fence out any in-flight window anyway
        self.flush()
        extras = self._fair_queue_heads(max_extras)
        with self.tracer.span("defrag", track="plane", cat="defrag",
                              standing=len(self.placer.tickets),
                              extras=len(extras)):
            result = defrag_mod.defrag(
                self.placer,
                extras=[(r.df, (r.tenant, r.klass)) for r in extras],
            )
        if result.committed:
            # standing tickets were re-placed under their old tids: refresh
            # the handles the active table holds
            for rid, (req, ticket) in list(self.active.items()):
                self.active[rid] = (req, self.placer.tickets[ticket.tid])
            for i, ticket in result.readmitted:
                req = extras[i]
                self.tenants[req.tenant].queue.remove(req)
                self._activate(req, ticket)
        return result

    # -- reporting -----------------------------------------------------------

    @staticmethod
    def _consensus_impl(counts: dict) -> str:
        """Fold per-impl solve counts back into the single ``kernel_impl``
        slot: the one impl when unanimous, ``"mixed(a,b)"`` otherwise —
        never last-writer-wins (the labeled truth lives in the registry)."""
        if not counts:
            return ""
        if len(counts) == 1:
            return next(iter(counts))
        return "mixed(" + ",".join(sorted(counts)) + ")"

    def _kernel_impl_counts(self) -> dict:
        """Solves per kernel backend — the labeled carrier for the
        non-additive ``Stats.kernel_impl`` across regional merges."""
        return dict(self.placer.stats.kernel_impls)

    def _solve_counts(self) -> tuple[int, int]:
        """``(solves, solve_n_sum)`` — the additive carrier for the
        non-additive ``Stats.solve_n`` (a mean) across regional merges."""
        st = self.placer.stats
        return st.solves, st.solve_n_sum

    def engine_stats(self) -> engine.Stats:
        """The service-level story in the engine's unified Stats vocabulary
        (preemptions / defrag rounds next to solver wall-clock)."""
        st = self.placer.stats
        s = engine.Stats(method=self.placer.method)
        s.preemptions = st.preempted
        s.defrag_rounds = st.defrag_rounds
        s.solve_ms = st.solve_ms
        s.overhead_ms = st.overhead_ms
        s.conflict_resolve_ms = st.conflict_resolve_ms
        s.stale_batches = st.stale_batches
        s.batch_size = self.micro_batch
        # non-additive fields, carried through the labeled counters
        # instead of being dropped (or last-writer-won) on the fold
        s.kernel_impl = self._consensus_impl(self._kernel_impl_counts())
        solves, n_sum = self._solve_counts()
        if solves:
            s.solve_n = round(n_sum / solves)
        return s

    def metrics_registry(self) -> obs_metrics.MetricsRegistry:
        """This plane's stats surfaces as one labeled registry snapshot
        (see ``repro_torch.obs.metrics``).  Parent planes merge per-region
        registries under a composed ``plane`` label — mirroring the
        gossip aggregation, a plane only reports what it can see."""
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.absorb_online_stats(reg, self.placer.stats)
        for k, v in self.placer.res.sync_stats.items():
            if v:
                reg.inc(f"residual.{k}", float(v))
        committed = self.committed_capacity()
        for t, st in self.tenants.items():
            reg.gauge("tenant.committed", committed[t], tenant=t)
            by_klass: dict[int, int] = {}
            for r in st.queue:
                by_klass[r.klass] = by_klass.get(r.klass, 0) + 1
            for k, c in by_klass.items():
                reg.gauge("queue.depth", float(c), tenant=t, klass=str(k))
        return reg

    def warmup(self, *, max_batch: Optional[int] = None, p: int = 5) -> int:
        """Build the kernel and touch the batch buckets admission will hit
        (delegates to
        :meth:`OnlinePlacer.warmup`); ``max_batch`` defaults to the
        micro-batch size."""
        return self.placer.warmup(
            max_batch=self.micro_batch if max_batch is None else max_batch,
            p=p,
        )

    def fairness_report(self) -> dict:
        """Actual standing shares vs weighted max-min targets (the shared
        :func:`policy.fairness_summary` definition)."""
        from .policy import fairness_summary

        rep = fairness_summary(
            self.committed_capacity(),
            self.queued_demand(),
            {t: st.cfg.weight for t, st in self.tenants.items()},
        )
        st = self.placer.stats
        rep["timing"] = {
            "solve_ms": st.solve_ms,
            "overhead_ms": st.overhead_ms,
            "conflict_resolve_ms": st.conflict_resolve_ms,
        }
        return rep

    def check_invariants(self) -> None:
        """Placer conservation + the control-plane ledger."""
        self.placer.check_invariants()
        ledger = self.conservation()
        assert ledger["ok"], f"ticket conservation violated: {ledger}"
        # every active rid's ticket is registered in the placer under its tid
        for rid, (req, ticket) in self.active.items():
            assert self.placer.tickets.get(ticket.tid) is ticket, (
                f"active rid {rid} holds a stale ticket"
            )
