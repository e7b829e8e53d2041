"""Background defragmentation: globally re-solve the standing allocation.

Port of ``repro/service/defrag.py``.

Greedy churn re-mapping (``OnlinePlacer.fail_node`` squeezing displaced
tickets into whatever residual happens to be free) fragments capacity: after
a fail/restore cycle the restored node sits empty while the standing
placements crowd the survivors, and later arrivals are rejected even though
a better global packing would fit them (Eidenbenz & Locher 2016: re-optimize
the *standing* allocation, not only the arrivals).

:func:`defrag` re-solves the whole ticket set as ONE batched kernel solve
against a blank residual snapshot (same node/link liveness, zero committed
load) and atomically commits the new placement only if it improves the
global objective — otherwise it restores the pre-pass state bit-for-bit.
The pass is transactional end to end:

- re-placement order is class-major (then admission order), so the
  re-solve can never leave a high class worse off because of a low one;
- the commit requires *every* standing ticket to re-place — defrag never
  drops or displaces standing work, whatever its class;
- re-placed tickets keep their ``tid`` (``OnlinePlacer.rekey``), so
  external handles survive the move;
- previously-rejected / queued requests (``extras``) are retried on the
  re-packed residual; admitting any of them raises the objective's leading
  term, which is what makes the pass worth running under overload.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core.graph import DataflowPath
from ..core.online import OnlinePlacer, Ticket


def global_objective(placer: OnlinePlacer) -> tuple[int, float]:
    """Higher is better: ``(tickets placed, -total route latency)``.

    Admitted count dominates (serving more standing work beats any latency
    win); total mapped latency breaks ties — the paper's mapping objective
    summed over the standing set.
    """
    return (
        len(placer.tickets),
        -sum(t.mapping.cost for t in placer.tickets.values()),
    )


@dataclasses.dataclass
class DefragResult:
    committed: bool  # anything changed (full re-pack, or extras admitted)
    repacked: bool  # the standing set was re-solved and the re-pack committed
    objective_before: tuple[int, float]
    objective_after: tuple[int, float]  # == before when nothing committed
    standing: int  # tickets in the re-solved set
    moved: int  # standing tickets whose assignment changed (0 if rolled back)
    readmitted: list  # extras admitted: (extra_index, Ticket)


def defrag(
    placer: OnlinePlacer,
    *,
    extras: Sequence[tuple[DataflowPath, tuple[str, int]]] = (),
) -> DefragResult:
    """One atomic re-optimization pass over ``placer``'s standing tickets.

    ``extras`` are (df, (tenant, klass)) pairs — typically queued or
    previously-rejected requests — retried on the re-packed network in the
    given order.  The full re-pack commits iff every standing ticket
    re-places AND the global objective strictly improves.  A greedy
    class-major re-pack is not guaranteed to re-place a set the incremental
    history managed to interleave (early tickets can grab the bandwidth a
    later one needs), so on a failed or non-improving re-pack the pass
    restores the pre-pass state bit-for-bit and *falls back* to retrying
    the extras on the current residual — still strictly
    objective-improving (admitted count only goes up), still displacing
    nobody.  The admission/rejection counters only ever record the net
    effect of what committed (speculative churn is reconciled away,
    leaving ``defrag_rounds`` and solver wall-clock).
    """
    snap = placer.snapshot()
    obj_before = global_objective(placer)
    standing = sorted(
        placer.tickets.values(), key=lambda t: (-t.klass, t.tid)
    )

    with placer.cache_suspended():
        # The re-pack runs with the SolutionCache bypassed: serving the
        # just-released standing mappings back from cache would make the
        # re-optimization a structural no-op (and the speculative
        # release/commit churn must not pollute the cache either way).

        # clear the standing set; re-solve it as one batched solve on the
        # blank residual (stats churn from this speculative work is
        # reconciled below)
        with placer.tracer.span("defrag.repack", track="placer", cat="defrag",
                                standing=len(standing)):
            for t in standing:
                placer.release(t, reason=None)
            new = placer.admit_many(
                [t.df for t in standing],
                metas=[(t.tenant, t.klass) for t in standing],
            )
        ok = all(nt is not None for nt in new)

        def _admit_extras() -> list[tuple[int, Ticket]]:
            """One batched solve over the extras (micro-batched admission
            with per-result revalidation, same as the service path)."""
            if not extras:
                return []
            tickets = placer.admit_many(
                [df for df, _ in extras], metas=[meta for _, meta in extras]
            )
            return [(i, t) for i, t in enumerate(tickets) if t is not None]

        readmitted: list[tuple[int, Ticket]] = []
        moved = 0
        obj_after = obj_before
        if ok:
            kept: list[Ticket] = []
            for t, nt in zip(standing, new):
                kept.append(placer.rekey(nt, t.tid))
                moved += int(nt.mapping.assign != t.mapping.assign)
            readmitted = _admit_extras()
            obj_after = global_objective(placer)

        repacked = ok and obj_after > obj_before
        # speculative solves did real work: solve accounting (wall clock,
        # solve counts, cache/warm traffic) survives rollback
        acct = placer.stats.solve_accounting()
        if not repacked:
            placer.restore(snap)
            placer.stats.restore_solve_accounting(acct)
            # fallback: keep the standing placement, retry the extras on the
            # current residual (probe rejections are not service rejections)
            readmitted = _admit_extras()
            placer.stats.rejected = snap["stats"].rejected
            placer.stats.defrag_rounds += 1
            placer.stats.defrag_commits += bool(readmitted)
            placer.check_invariants()
            return DefragResult(
                committed=bool(readmitted),
                repacked=False,
                objective_before=obj_before,
                objective_after=global_objective(placer),
                standing=len(standing),
                moved=0,
                readmitted=readmitted,
            )

    # committed re-pack: rebase stats on the snapshot so the speculative
    # release/re-admit churn vanishes and only the net effect remains
    stats = snap["stats"].clone()
    stats.restore_solve_accounting(acct)
    stats.admitted += len(readmitted)
    stats.defrag_rounds += 1
    stats.defrag_commits += 1
    placer.stats = stats
    placer.check_invariants()
    return DefragResult(
        committed=True,
        repacked=True,
        objective_before=obj_before,
        objective_after=obj_after,
        standing=len(standing),
        moved=moved,
        readmitted=readmitted,
    )
