"""Cross-tenant allocation policy: weighted max-min shares + drain order.

Port of ``repro/service/policy.py`` (plain Python).

The paper's regime is many long-running data-flow applications competing
for one network.  Benoit et al. 2009 show that concurrent in-network
stream-processing applications need an *explicit* cross-application
allocation policy — per-application greedy admission (FCFS) lets one heavy
tenant take whatever arrives first.  This module is that policy, kept free
of any service state so it can be unit-tested and swapped:

- :func:`maxmin_shares` — weighted max-min (water-filling) allocation of a
  scalar capacity among tenants with demands; the fairness target the
  control plane is graded against.
- :class:`FairSharePolicy` — given the per-tenant queues and the live
  committed-capacity accounting, picks which queued requests the next
  ``admit_many`` micro-batch should attempt, such that under overload each
  tenant's *standing committed compute* converges to its weighted max-min
  share of whatever total the network can actually hold (the total is never
  known a priori — feasibility is decided by the placement DP — so shares
  are enforced against the observed committed total, self-normalizing).
- Preemption-class rules: :func:`may_preempt` is the single place encoding
  "a class-k ticket is only ever displaced by class > k".

Classes are small ints; three conventional levels are named here but any
int works (higher = more important).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

# Conventional preemption classes (any int is a valid class; higher wins).
CLASS_BEST_EFFORT = 0
CLASS_STANDARD = 1
CLASS_CRITICAL = 2


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Registration record for one tenant.

    ``weight`` sets the tenant's share under weighted max-min fairness;
    ``budget`` (optional) is an absolute ceiling on the tenant's committed
    compute regardless of its fair share — a hard cap for capped plans.
    """

    name: str
    weight: float = 1.0
    budget: Optional[float] = None

    def __post_init__(self):
        assert self.weight > 0, "tenant weight must be positive"


def maxmin_shares(
    demands: Mapping[str, float],
    weights: Mapping[str, float],
    capacity: float,
) -> dict[str, float]:
    """Weighted max-min (progressive water-filling) allocation.

    Each tenant receives at most its demand; unused share of a satisfied
    tenant is redistributed among the still-unsatisfied ones in proportion
    to weight.  The classic fixed point: no tenant can gain without a
    tenant of equal-or-smaller normalized allocation losing.
    """
    shares = {t: 0.0 for t in demands}
    active = {t for t, d in demands.items() if d > 0}
    remaining = max(float(capacity), 0.0)
    while active and remaining > 1e-12:
        wsum = sum(weights[t] for t in active)
        level = {t: remaining * weights[t] / wsum for t in active}
        satisfied = [
            t for t in active if demands[t] - shares[t] <= level[t] + 1e-12
        ]
        if not satisfied:
            # nobody saturates: hand out the full proportional level
            for t in active:
                shares[t] += level[t]
            break
        for t in satisfied:
            take = demands[t] - shares[t]
            shares[t] = demands[t]
            remaining -= take
            active.remove(t)
    return shares


def may_preempt(victim_klass: int, aggressor_klass: int) -> bool:
    """Preemption is strictly class-ordered: > only, never >=."""
    return victim_klass < aggressor_klass


def fairness_summary(
    held: Mapping[str, float],
    queued: Mapping[str, float],
    weights: Mapping[str, float],
) -> dict:
    """Actual standing shares vs weighted max-min targets — the single
    definition both the centralized and the regional plane report (and
    that the CI fairness gates compare between them).

    Shares are taken over the *observed* committed total (the network
    decides what fits; the policy only divides it) and targets come from
    :func:`maxmin_shares` with each tenant's demand = committed + queued —
    a tenant demanding less than its share keeps only its demand, the
    rest is redistributed by weight."""
    held = dict(held)
    total = sum(held.values())
    demands = {t: held[t] + queued[t] for t in held}
    target = maxmin_shares(demands, weights, total)
    deviation = {
        t: abs(held[t] - target[t]) / target[t]
        for t in held
        if target[t] > 1e-9
    }
    return {
        "committed": held,
        "queued_demand": dict(queued),
        "total_committed": total,
        "target_shares": target,
        "deviation": deviation,
        "max_deviation": max(deviation.values(), default=0.0),
    }


class FairSharePolicy:
    """Weighted max-min scheduler over per-tenant FIFO queues.

    ``select`` simulates granting requests one at a time: a tenant is
    *eligible* while its committed compute (including tentative grants this
    round) stays within its weighted fraction of the total committed
    compute, plus a slack.  Among eligible backlogged tenants the most
    under-served one (smallest committed/weight) drains first — the
    water-filling order.

    The slack absorbs request granularity: fluid shares cannot be tracked
    finer than one request, and a slack much smaller than a typical request
    stalls the drain far below what the network holds (every tenant looks
    "over share" the moment it commits one request).  ``select`` therefore
    uses ``max(slack, largest head request)`` each round — the configured
    ``slack`` is a floor, and the fairness error stays bounded by one
    request size, shrinking relative to the total as the system fills.

    The fraction test self-normalizes: it needs no estimate of how much the
    network can hold.  Whatever total the placement DP admits, each
    backlogged tenant's standing share converges to weight_t / sum(weights
    of demanding tenants) of it.
    """

    def __init__(self, *, slack: float = 0.5):
        self.slack = float(slack)

    # -- eligibility --------------------------------------------------------

    def eligible(
        self,
        cfg: TenantConfig,
        creq: float,
        virt: Mapping[str, float],
        frac: float,
        slack: Optional[float] = None,
    ) -> bool:
        held = virt[cfg.name]
        if cfg.budget is not None and held + creq > cfg.budget + 1e-9:
            return False
        if held <= 0:
            # granularity floor: a backlogged tenant holding nothing may
            # always attempt its head request — fluid max-min shares are
            # meaningless below one request, and without this floor a
            # request larger than the slack could wedge the whole drain
            return True
        total = sum(virt.values())
        s = self.slack if slack is None else slack
        return held + creq <= frac * (total + creq) + s

    # -- drain selection ----------------------------------------------------

    def select(
        self,
        tenants: Mapping[str, TenantConfig],
        queues: Mapping[str, Sequence],
        committed: Mapping[str, float],
        slots: int,
    ) -> list:
        """Pick up to ``slots`` queued requests for the next micro-batch.

        ``queues`` maps tenant -> FIFO of requests exposing ``creq_sum``;
        queues are only read (the caller pops the returned heads).  Per
        tenant the FIFO order is preserved; an ineligible head blocks that
        tenant for the round (no reordering within a tenant).
        """
        virt = {t: float(committed.get(t, 0.0)) for t in tenants}
        idx = {t: 0 for t in tenants}
        picked: list = []
        while len(picked) < slots:
            backlogged = [t for t in tenants if idx[t] < len(queues.get(t, ()))]
            if not backlogged:
                break
            # granularity-aware slack: at least one head-request size
            slack = max(
                self.slack,
                max(queues[t][idx[t]].creq_sum for t in backlogged),
            )
            # tenants with live demand split the pie; idle tenants' weight
            # is redistributed (work conservation)
            demanding = [
                t for t in tenants if virt[t] > 0 or t in backlogged
            ]
            wsum = sum(tenants[t].weight for t in demanding)
            best = None
            for t in sorted(
                backlogged,
                key=lambda t: (virt[t] / tenants[t].weight, t),
            ):
                req = queues[t][idx[t]]
                frac = tenants[t].weight / wsum
                if self.eligible(tenants[t], req.creq_sum, virt, frac,
                                 slack=slack):
                    best = (t, req)
                    break
            if best is None:
                break
            t, req = best
            idx[t] += 1
            virt[t] += req.creq_sum
            picked.append(req)
        return picked

    # -- reporting ----------------------------------------------------------

    def fair_fractions(
        self,
        tenants: Mapping[str, TenantConfig],
        demanding: Sequence[str],
    ) -> dict[str, float]:
        """Weight-proportional target fractions among demanding tenants."""
        wsum = sum(tenants[t].weight for t in demanding) or 1.0
        return {t: tenants[t].weight / wsum for t in demanding}
