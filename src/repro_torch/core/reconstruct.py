"""Parent-pointer reconstruction shared by the tensorized DP backends.

Numpy copy of ``repro/core/reconstruct.py``; the fallback is this
package's own ``leastcost_python``.

Before the engine refactor this logic existed near-verbatim three times
(``leastcost._reconstruct``, an inline copy in the tensorized DP and another
in ``distributed.leastcost_shard_map``).  The DP does not carry visited
sets, so two anomalies are possible and both are handled here:

- *broken chain*: a parent pointer is missing (-1) or the walk exceeds the
  ``n * (p + 2)`` guard — the backtrack cannot reach ``(src, 0)``;
- *revisit anomaly*: the chain closes but the reconstructed route visits a
  resource node twice (possible only in adversarial instances because the
  state drops the carried route) — caught by ``validate_mapping``.

Either way the sound path-carrying ``leastcost_python`` is used as the
fallback (rare; counted in Stats / benchmarks).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .graph import DataflowPath, Mapping, ResourceGraph, validate_mapping
from .problem import BIG


def backtrack(
    par_v: np.ndarray,
    par_j: np.ndarray,
    *,
    src: int,
    dst: int,
    best_j: int,
    p: int,
    n: int,
) -> tuple[np.ndarray, list[int], bool]:
    """Walk parent pointers from (dst, best_j) to (src, 0).

    Returns (assign (p,) int64, route in travel order, chain_ok).  When the
    chain is broken, ``assign`` may contain -1 entries.
    """
    assign = np.full(p, -1, np.int64)
    k = int(best_j)
    assign[k:p] = dst
    w, route, guard, ok = dst, [dst], 0, True
    while not (w == src and k == 0):
        v, j = int(par_v[w, k]), int(par_j[w, k])
        if v < 0 or guard > n * (p + 2):
            ok = False
            break
        assign[j:k] = v
        route.append(v)
        w, k = v, j
        guard += 1
    route.reverse()
    return assign, route, ok and int(assign.min()) >= 0


def reconstruct_mapping(
    rg: ResourceGraph,
    df: DataflowPath,
    par_v: np.ndarray,
    par_j: np.ndarray,
    best_cost: float,
    best_j: int,
    *,
    validate: bool = True,
    fallback: Optional[Callable] = None,
    use_fallback: bool = True,
    stats=None,
) -> Optional[Mapping]:
    """Backtrack + validate + (optional) sound fallback.

    ``stats`` (any object with ``validated`` / ``fallback_used`` attributes,
    e.g. ``HeuristicStats`` or the engine's ``Stats``) is updated in place.
    ``fallback`` defaults to ``leastcost_python``.
    """
    if best_cost >= BIG / 2:
        return None
    par_v = np.asarray(par_v)
    par_j = np.asarray(par_j)
    assign, route, ok = backtrack(
        par_v, par_j, src=df.src, dst=df.dst, best_j=best_j, p=df.p, n=rg.n
    )
    if ok:
        m = Mapping(tuple(int(a) for a in assign), tuple(route), float(best_cost))
        if validate:
            ok, _reason = validate_mapping(rg, df, m)
        if stats is not None:
            stats.validated = bool(ok)
        if ok:
            return m
    elif stats is not None:
        stats.validated = False
    if not use_fallback:
        return None
    if stats is not None:
        stats.fallback_used = True
    if fallback is None:
        from .leastcost import leastcost_python

        fallback = leastcost_python
    m, _ = fallback(rg, df)
    return m
