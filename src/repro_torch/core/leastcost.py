"""LeastCostMap heuristic (paper §3.4.1), two implementations.

Port of ``repro/core/leastcost.py``.

1. ``leastcost_python`` — faithful path-carrying version (numpy copy): the
   exact PathMap relaxation with ``M(u, j)`` pruned to the single cheapest
   partial map per (node, prefix-length).  ``core.reconstruct`` falls back
   to it on a broken parent chain or a revisit.

2. ``leastcost_torch`` / ``leastcost_torch_batched`` — the tensorized DP
   over the tropical (min,+) semiring.  State ``C[b, v, j]`` = min cost of
   placing the first ``j`` dataflow nodes of request ``b`` on a route ending
   at ``v``; one fused superstep (place + move + monotone update) per round,
   iterated to fixpoint, for B requests against one shared network.  On a
   CUDA device each superstep is the hand-written kernel of
   ``repro_torch.kernels.minplus.batched``; on the CPU its plain version.
   The reference's per-request vmapped path is not ported: single requests
   run the batched path with B = 1.

The fixpoint loop keeps the round counter and the "changed" flag on the
device (:func:`repro_torch.kernels.minplus.batched.advance_flags`): dispatch
enqueues a chunk of supersteps and returns without waiting; finalize reads
the control word and enqueues more chunks until the loop is done.  A
superstep past the fixpoint (or past ``max_rounds``) is a no-op, so the
round count equals the reference's ``lax.while_loop`` trip count exactly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..kernels.minplus import batched as _batched
from .graph import DataflowPath, Mapping, ResourceGraph
from .problem import (
    BIG,
    EPS_BW,
    EPS_CAP_F32,
    EPS_COST,
    make_cap_ok,
    resolve_device,
    stack_requests,
    to_device,
)
from .reconstruct import reconstruct_mapping

# supersteps enqueued per host check of the device control word
CHUNK = 8
KERNEL_IMPLS = ("cuda", "plain")


@dataclasses.dataclass
class HeuristicStats:
    max_set_size: int = 0
    total_maps_generated: int = 0
    rounds: int = 0
    fallback_used: bool = False
    validated: bool = True
    kernel_impl: str = ""  # "", "cuda" or "plain"


# ---------------------------------------------------------------------------
# 1. Faithful path-carrying LeastCostMap (centralized, paper §3.4.1)
# ---------------------------------------------------------------------------


def leastcost_python(
    rg: ResourceGraph, df: DataflowPath
) -> tuple[Optional[Mapping], HeuristicStats]:
    p, n = df.p, rg.n
    src, dst = df.src, df.dst
    stats = HeuristicStats()
    # M[u][j] = (cost, assign, route) | None — single cheapest per (u, j).
    M: list[list[Optional[tuple]]] = [[None] * (p + 1) for _ in range(n)]
    best: Optional[Mapping] = None

    cap_ok = make_cap_ok(rg, df)

    for j in range(1, p):
        if not cap_ok(0, j, src):
            break
        M[src][j] = (0.0, (src,) * j, (src,))
        stats.total_maps_generated += 1
    if cap_ok(0, p, src) and src == dst:
        best = Mapping((src,) * p, (src,), 0.0)

    edges = list(rg.edges())
    fresh = {(src, j) for j in range(1, p) if M[src][j]}
    for rnd in range(n - 1):
        stats.rounds = rnd + 1
        new_fresh: set[tuple[int, int]] = set()
        for (u, v) in edges:
            for j in range(1, p):
                if (u, j) not in fresh or M[u][j] is None:
                    continue
                if float(rg.bw[u, v]) + EPS_BW < float(df.breq[j - 1]):
                    continue
                cost, assign, route = M[u][j]
                if v in route:
                    continue
                ncost = cost + float(rg.lat[u, v])
                if v == dst:
                    if cap_ok(j, p, v):
                        m = Mapping(assign + (v,) * (p - j), route + (v,), ncost)
                        if best is None or m.cost < best.cost:
                            best = m
                else:
                    for x in range(0, p - j):
                        if not cap_ok(j, j + x, v):
                            break
                        cur = M[v][j + x]
                        if cur is None or ncost < cur[0] - EPS_COST:
                            M[v][j + x] = (ncost, assign + (v,) * x, route + (v,))
                            stats.total_maps_generated += 1
                            new_fresh.add((v, j + x))
        stats.max_set_size = max(
            stats.max_set_size, sum(1 for row in M for e in row if e is not None)
        )
        fresh = new_fresh
        if not fresh:
            break
    return best, stats


# ---------------------------------------------------------------------------
# 2. Tensorized batched DP
# ---------------------------------------------------------------------------


def warm_seed_from_mapping(rg: ResourceGraph, df: DataflowPath, mapping):
    """Host-side O(p + route) walk turning a previously-committed (now
    possibly infeasible) mapping into a DP cost frontier.

    Walks the mapping's route edge by edge under the *current* residual
    ``rg``, emitting one seed state per arrival ``(v, j, cost)`` with its
    parent ``(u, j_prev)`` and stopping at the first constraint violation.
    Every seeded state is achievable under the current residual, so the
    relaxation can only improve on it.  Returns a seed dict (numpy arrays
    ``v/j/cost/pv/pj``) or None when not even the first hop survives.
    """
    assign, route = mapping.assign, mapping.route
    cap, bw, lat = rg.cap, rg.bw, rg.lat
    p = df.p
    sv, sj, sc, spv, spj = [], [], [], [], []
    pos = 0  # last df node whose outgoing edge has been carried
    prev_j = 0  # arrival prefix length at the current route node
    cost = np.float32(0.0)
    for u, w in zip(route[:-1], route[1:]):
        while pos + 1 < p and assign[pos + 1] == u:
            pos += 1
        # df nodes placed at u this visit: prev_j .. pos inclusive
        block = float(np.sum(df.creq[prev_j:pos + 1], dtype=np.float64))
        if block > float(cap[u]) + EPS_CAP_F32:
            break
        if pos >= p - 1:
            break  # nothing left to move; dst tail handled by the DP
        lw = float(lat[u, w])
        if not np.isfinite(lw):
            break
        if float(bw[u, w]) < float(df.breq[pos]):
            break  # same exact gate as the DP move step
        cost = np.float32(cost + np.float32(lw))
        sv.append(w)
        sj.append(pos + 1)
        sc.append(cost)
        spv.append(u)
        spj.append(prev_j)
        prev_j = pos + 1
    if not sv:
        return None
    return {
        "v": np.asarray(sv, np.int32), "j": np.asarray(sj, np.int32),
        "cost": np.asarray(sc, np.float32),
        "pv": np.asarray(spv, np.int32), "pj": np.asarray(spj, np.int32),
    }


def stack_warm_seeds(warm_starts, B: int, p_max: int, *, device) -> dict:
    """Stack per-request seed dicts (None = no seed) into padded (B, S)
    tensors.  Pad slots use ``cost=BIG`` + parents ``-1``: ``_apply_warm``
    merges with amin/amax, so a pad slot is a no-op against the cold init
    (``C0=BIG``, parents ``-1``)."""
    S = 1
    for w in warm_starts:
        if w is not None and len(w["v"]) > S:
            S = len(w["v"])
    S = 1 << (S - 1).bit_length()
    wv = np.zeros((B, S), np.int32)
    wj = np.zeros((B, S), np.int32)
    wc = np.full((B, S), BIG, np.float32)
    wpv = np.full((B, S), -1, np.int32)
    wpj = np.full((B, S), -1, np.int32)
    for b in range(min(B, len(warm_starts))):
        w = warm_starts[b]
        if w is None:
            continue
        s = len(w["v"])
        wv[b, :s] = w["v"]
        wj[b, :s] = w["j"]
        wc[b, :s] = w["cost"]
        wpv[b, :s] = w["pv"]
        wpj[b, :s] = w["pj"]
    dev = torch.device(device)
    return {
        "warm_v": to_device(wv, dev), "warm_j": to_device(wj, dev),
        "warm_c": to_device(wc, dev), "warm_pv": to_device(wpv, dev),
        "warm_pj": to_device(wpj, dev),
    }


def _apply_warm(C0, pv0, pj0, tensors):
    """Merge a warm-start frontier into the cold DP init (B, n, K).  ``amin``
    on costs keeps every finite C entry realizable; ``amax`` on parents is
    exact because real seeds target distinct ``(v, j)`` cells whose cold
    parents are ``-1``, and pad slots carry ``-1``/``BIG`` no-ops."""
    B, n, K = C0.shape
    b = torch.arange(B, device=C0.device)[:, None]
    flat = (b * (n * K) + tensors["warm_v"].long() * K
            + tensors["warm_j"].long()).reshape(-1)
    C0 = C0.reshape(-1).scatter_reduce(
        0, flat, tensors["warm_c"].reshape(-1), "amin").reshape(B, n, K)
    pv0 = pv0.reshape(-1).scatter_reduce(
        0, flat, tensors["warm_pv"].reshape(-1), "amax").reshape(B, n, K)
    pj0 = pj0.reshape(-1).scatter_reduce(
        0, flat, tensors["warm_pj"].reshape(-1), "amax").reshape(B, n, K)
    return C0, pv0, pj0


def _place_step(C, cap, prefix):
    """P[v,k] = min over x>=0 of C[v,k-x] s.t. prefix[k]-prefix[k-x] <= cap[v],
    with pj[v,k] = the achieving j = k-x (ties keep the largest j).

    Transcription of the reference's ``_place_step``, which is plain jnp
    outside any Pallas kernel: the batched plain place with B = 1.  C (n, K).
    """
    P, pj = _batched._place_plain(C[None], cap, prefix[None])
    return P[0], pj[0]


def _default_impl(device: torch.device, kernel_impl: Optional[str]) -> str:
    impl = kernel_impl or ("cuda" if device.type == "cuda" else "plain")
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, "
                         f"got {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel_impl='cuda' needs a CUDA device, got {device}")
    return impl


class _Relaxation:
    """The batched fixpoint loop on the device: state, control word and the
    superstep implementation.  ``advance`` only enqueues work; ``finish``
    is the one place the host reads the device."""

    def __init__(self, tensors: dict, B: int, n: int, p: int,
                 max_rounds: int, impl: str):
        K = p + 1
        dev = tensors["prefix"].device
        self.B, self.n, self.K = B, n, K
        self.tensors = tensors
        self.max_rounds = int(max_rounds)
        self.enqueued = 0
        if impl == "cuda":  # one kernel workspace for every superstep
            self.step = functools.partial(
                _batched.batched_superstep,
                workspace=_batched.make_workspace(B, n, K, dev))
        else:
            self.step = _batched.plain_superstep
        big = torch.full((B, 1), float(BIG), dtype=torch.float32, device=dev)
        # breq_k[b, k] = bandwidth of the dataflow edge carried when k nodes
        # are placed (edge (k-1, k)); k = 0 and k = p get BIG (no move)
        self.breq_k = torch.cat([big, tensors["breq"], big], dim=1).contiguous()
        # arrival state at src with 0 nodes placed costs 0 (a scatter of a
        # python scalar: index assignment would copy it to the device and
        # synchronize the host)
        C = torch.full((B, n * K), float(BIG), dtype=torch.float32,
                       device=dev)
        C = C.scatter_(1, tensors["src"].long()[:, None] * K, 0.0)
        C = C.view(B, n, K)
        pv = torch.full((B, n, K), -1, dtype=torch.int32, device=dev)
        pj = torch.full((B, n, K), -1, dtype=torch.int32, device=dev)
        if "warm_v" in tensors:
            C, pv, pj = _apply_warm(C, pv, pj, tensors)
        self.state = (C.contiguous(), pv.contiguous(), pj.contiguous())
        # [t, active, changed, max_rounds]
        self.flags = to_device(np.array([0, 1, 0, self.max_rounds], np.int32),
                               dev)

    def advance(self, k: int) -> None:
        t = self.tensors
        for _ in range(min(k, self.max_rounds - self.enqueued)):
            self.state = self.step(*self.state, t["lat"], t["bw"], t["cap"],
                                   t["prefix"], self.breq_k, flags=self.flags)
            self.enqueued += 1

    def finish(self) -> int:
        """Run to the fixpoint (or the round cap); returns the round count."""
        while True:
            t, active = (int(x) for x in self.flags[:2].tolist())
            if not active or self.enqueued >= self.max_rounds:
                return t
            self.advance(CHUNK)

    def answer(self):
        """Per request: min over j < p_eff of C[dst, j] + the tail placed on
        dst.  Returns (best_cost, best_j) device tensors."""
        t = self.tensors
        C = self.state[0]
        B, K = self.B, self.K
        prefix, cap = t["prefix"], t["cap"]
        p_eff = t["p_eff"].long()
        j_idx = torch.arange(K, device=C.device)
        pre_pe = torch.gather(prefix, 1, p_eff[:, None])  # (B, 1)
        cap_dst = cap[t["dst"].long()]  # (B,)
        feas = (j_idx[None, :] < p_eff[:, None]) & (
            pre_pe - prefix <= cap_dst[:, None] + EPS_CAP_F32)
        C_dst = C[torch.arange(B, device=C.device), t["dst"].long(), :]
        final = torch.where(feas, C_dst, float(BIG))
        best_j = torch.argmin(final, dim=1)
        best_cost = torch.gather(final, 1, best_j[:, None])[:, 0]
        return best_cost, best_j


def _leastcost_dp_batched(tensors, B: int, n: int, p: int, max_rounds: int,
                          impl: str):
    """Run B requests' relaxations to fixpoint, synchronously.  Returns
    ``(C, par_v, par_j, best_cost, best_j, rounds)`` like the reference's
    ``_leastcost_dp_batched`` (rounds as a python int)."""
    relax = _Relaxation(tensors, B, n, p, max_rounds, impl)
    relax.advance(CHUNK)
    rounds = relax.finish()
    best_cost, best_j = relax.answer()
    return (*relax.state, best_cost, best_j, rounds)


@dataclasses.dataclass(eq=False)
class PendingDP:
    """An in-flight batched DP: supersteps enqueued, not yet synced.

    Holds the tensors it was dispatched with (out-of-place residual updates
    never reach them), so later residual mutations cannot corrupt the
    solve — the basis of the online placer's cross-batch pipeline."""

    rg: ResourceGraph  # host residual snapshot (reconstruction/validation)
    dfs: list
    relax: _Relaxation
    kernel_impl: str = ""
    validate: bool = True
    warm: bool = False  # True iff this solve was warm-start seeded


def leastcost_torch_batched_dispatch(
    rg: ResourceGraph,
    dfs: list,
    *,
    device=None,
    validate: bool = True,
    max_rounds: Optional[int] = None,
    kernel_impl: Optional[str] = None,
    bucket_batch: bool = False,
    graph_tensors=None,
    warm_starts=None,
) -> PendingDP:
    """Dispatch the batched DP without waiting for the result.

    Enqueues the first chunk of supersteps and returns a :class:`PendingDP`;
    the caller overlaps host work and synchronizes in
    :func:`leastcost_torch_batched_finalize`.

    ``graph_tensors`` injects device-resident ``{cap, bw, lat}`` (see
    ``core.residual.ResidualState.device_tensors``); ``rg`` is still the
    host graph the reconstruction walks.  ``warm_starts`` (aligned with
    ``dfs``) seeds the frontier per request: None, a seed dict from
    :func:`warm_seed_from_mapping`, or a prior ``Mapping``.
    ``bucket_batch=True`` pads the batch to the next power of two.
    """
    assert dfs
    dev = resolve_device(device)
    impl = _default_impl(dev, kernel_impl)
    n = rg.n
    B = len(dfs)
    if bucket_batch:
        B = 1 << (B - 1).bit_length()  # next power of two
    tensors, p_max = stack_requests(rg, dfs, pad_to=B, device=dev,
                                    graph_tensors=graph_tensors)
    warm = False
    if warm_starts is not None:
        seeds = [
            w if (w is None or isinstance(w, dict))
            else warm_seed_from_mapping(rg, df, w)
            for w, df in zip(warm_starts, dfs)
        ]
        if any(s is not None for s in seeds):
            tensors = dict(tensors, **stack_warm_seeds(seeds, B, p_max,
                                                       device=dev))
            warm = True
    max_rounds = max_rounds or (n - 1 if n > 1 else 1)
    relax = _Relaxation(tensors, B, n, p_max, max_rounds, impl)
    relax.advance(CHUNK)
    return PendingDP(rg, list(dfs), relax, kernel_impl=impl,
                     validate=validate, warm=warm)


def leastcost_torch_batched_finalize(pending: PendingDP, stats=None) -> list:
    """Finish an in-flight batched DP and reconstruct its mappings: the only
    host synchronization point of the batched path."""
    relax = pending.relax
    rounds = relax.finish()
    best_cost, best_j = relax.answer()
    B = len(pending.dfs)
    par_v = relax.state[1][:B].cpu().numpy()
    par_j = relax.state[2][:B].cpu().numpy()
    best_cost = best_cost[:B].cpu().numpy()
    best_j = best_j[:B].cpu().numpy()
    if stats is not None:
        stats.kernel_impl = pending.kernel_impl
        stats.rounds = rounds
    out = []
    for i, df in enumerate(pending.dfs):
        per = HeuristicStats()
        out.append(
            reconstruct_mapping(
                pending.rg, df, par_v[i], par_j[i],
                float(best_cost[i]), int(best_j[i]),
                validate=pending.validate, stats=per,
            )
        )
        if stats is not None:
            stats.fallback_used |= per.fallback_used
            stats.validated &= per.validated
    return out


def leastcost_torch_batched(rg: ResourceGraph, dfs: list, *, stats=None,
                            **cfg) -> list:
    """Solve many mapping requests on ONE shared resource network in one
    batched DP.  Requests of mixed ``p`` are padded.  Returns a list of
    (Mapping | None); ``stats`` (e.g. the engine's ``Stats``) aggregates
    ``rounds``, ``kernel_impl``, ``fallback_used`` and ``validated``.
    Keyword arguments are those of :func:`leastcost_torch_batched_dispatch`.
    """
    pending = leastcost_torch_batched_dispatch(rg, dfs, **cfg)
    return leastcost_torch_batched_finalize(pending, stats=stats)


def leastcost_torch(
    rg: ResourceGraph,
    df: DataflowPath,
    *,
    device=None,
    kernel_impl: Optional[str] = None,
    max_rounds: Optional[int] = None,
    validate: bool = True,
    warm_start=None,
) -> tuple[Optional[Mapping], HeuristicStats]:
    """Tensorized LeastCostMap for one request: the batched path with B = 1.
    Returns (mapping | None, stats).  ``warm_start`` (a seed dict from
    :func:`warm_seed_from_mapping` or a prior ``Mapping``) seeds the DP
    frontier; pair with a small ``max_rounds`` for a bounded correction."""
    dev = resolve_device(device)
    impl = _default_impl(dev, kernel_impl)
    n, p = rg.n, df.p
    stats = HeuristicStats(kernel_impl=impl)
    max_rounds = max_rounds or (n - 1 if n > 1 else 1)
    if warm_start is not None and not isinstance(warm_start, dict):
        warm_start = warm_seed_from_mapping(rg, df, warm_start)
    tensors, _ = stack_requests(rg, [df], device=dev)
    if warm_start is not None:
        tensors = dict(tensors, **stack_warm_seeds([warm_start], 1, p,
                                                   device=dev))
    C, par_v, par_j, best_cost, best_j, rounds = _leastcost_dp_batched(
        tensors, B=1, n=n, p=p, max_rounds=max_rounds, impl=impl)
    stats.rounds = rounds
    stats.max_set_size = int((C[0] < float(BIG) / 2).sum())
    best_cost = float(best_cost[0])
    if best_cost >= BIG / 2:
        return None, stats
    # Backtrack parent pointers; on a broken chain or revisit anomaly the
    # sound path-carrying version is substituted (rare; counted in stats).
    m = reconstruct_mapping(
        rg, df, par_v[0].cpu().numpy(), par_j[0].cpu().numpy(), best_cost,
        int(best_j[0]), validate=validate, stats=stats,
    )
    return m, stats
