"""Decentralized BCPM over ``torch.distributed`` ranks (the paper's Alg. 4, BSP).

Port of ``repro/core/distributed.py``.  The paper's constraint — "each node
in the resource network is aware of the state of its immediate neighborhood
only" — maps onto ranks that each own a contiguous block of resource nodes:
their capacities, their partial-map state rows ``C[v, :]`` and their
*incoming* link columns ``lat[:, owned]``, ``bw[:, owned]``.  One
relaxation superstep is

1. a local *place* step (:func:`repro_torch.core.leastcost._place_step`,
   plain torch like the reference's jnp, ties to the largest j);
2. the frontier exchange: an ``all_gather`` of the placed frontier ``P``
   and its argmin ``pj`` (the bulk-synchronous analogue of the paper's
   asynchronous message flood);
3. a local *move* over the owned columns through the masked min-plus
   kernel (``kernels/minplus/csrc/masked_minplus.cu``) on a CUDA device, or
   its plain version.

Termination is an all-reduced ``changed`` flag (the paper's quiescence
detection).  Message accounting matches the asynchronous algorithm: a
superstep "sends" one message per (improved frontier state, outgoing
neighbour) pair, counted in float32 like the reference so the totals agree
with it exactly, in all and across partitions.

With ``group=None`` and no initialized default process group the engine runs
as one rank without collectives; otherwise every rank of ``group`` (gloo on
the CPU, NCCL on CUDA devices, one device per rank) calls it with the same
request and returns the same mapping.

The reference's ``_local_move`` does not clamp ``BIG + lat``; the kernel
does.  That changes only move results >= BIG, which never pass the update
test ``C' < C - EPS_IMPROVE`` (C <= BIG), so the state, the message counts
and the mapping are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.minplus import minplus as _minplus
from .graph import DataflowPath, Mapping, ResourceGraph
from .leastcost import HeuristicStats, _default_impl, _place_step
from .problem import (
    BIG,
    EPS_CAP_F32,
    EPS_IMPROVE,
    creq_prefix,
    finite_lat,
    resolve_device,
    to_device,
)
from .reconstruct import reconstruct_mapping


@dataclasses.dataclass
class DistStats(HeuristicStats):
    messages_total: int = 0  # async-equivalent messages
    messages_cross_device: int = 0  # messages that crossed a partition
    supersteps: int = 0


def _pad_to(x: np.ndarray, n_pad: int, fill) -> np.ndarray:
    pad = [(0, n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def _gather_rows(group, D: int, *cols: torch.Tensor) -> list[torch.Tensor]:
    """All-gather row blocks of several (n_loc, K) float32/int32 tensors in
    one collective (int32 travels bit-cast as float32)."""
    if group is None:
        return list(cols)
    buf = torch.cat([c.view(torch.float32) for c in cols], dim=1)
    out = torch.empty((D * buf.shape[0], buf.shape[1]), dtype=buf.dtype,
                      device=buf.device)
    dist.all_gather(list(out.chunk(D)), buf, group=group)
    K = cols[0].shape[1]
    return [out[:, i * K:(i + 1) * K].contiguous().view(c.dtype)
            for i, c in enumerate(cols)]


def _dist_body(C, par_v, par_j, msgs, cap_loc, lat_cols, bw_cols, prefix,
               breq_k, deg, *, move, group, D):
    """One superstep on this rank's block (the reference's ``_dist_body``).
    ``msgs`` holds the float32 (total, cross-partition) message counts and
    ``deg`` the owned nodes' (out-degree, cross-partition out-degree).
    Returns ``(C, par_v, par_j, msgs, changed)``, ``changed`` a 0-d bool
    tensor that is the same on every rank."""
    P_loc, pj_loc = _place_step(C, cap_loc, prefix)
    P_all, pj_all = _gather_rows(group, D, P_loc, pj_loc)  # frontier exchange
    Cmv, pv = move(P_all, lat_cols, bw_cols, breq_k)
    upd = Cmv < C - EPS_IMPROVE
    Cn = torch.where(upd, Cmv, C)
    par_vn = torch.where(upd, pv, par_v)
    par_jn = torch.where(upd, torch.gather(pj_all, 0, pv.long()), par_j)
    # a newly accepted map at owned node (w, k) would be forwarded to every
    # outgoing neighbour of w: one async message each
    inc = torch.stack([(upd * deg[:, 0, None]).sum(),
                       (upd * deg[:, 1, None]).sum(),
                       upd.any().to(torch.float32)])
    if group is not None:
        dist.all_reduce(inc, group=group)
    return Cn, par_vn, par_jn, msgs + inc[:2], inc[2] > 0


def leastcost_shard_map(
    rg: ResourceGraph,
    df: DataflowPath,
    *,
    group=None,
    device=None,
    kernel_impl: Optional[str] = None,
    validate: bool = True,
    max_rounds: Optional[int] = None,
) -> tuple[Optional[Mapping], DistStats]:
    """LeastCostMap with the resource graph partitioned over the ranks of
    ``group``.  ``kernel_impl`` picks the move: ``"cuda"`` (the default on a
    CUDA device) or ``"plain"``."""
    dev = resolve_device(device)
    impl = _default_impl(dev, kernel_impl)
    move = (_minplus.masked_minplus_cuda if impl == "cuda"
            else _minplus.masked_minplus_plain)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    D = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    n, p = rg.n, df.p
    K = p + 1
    n_pad = -(-n // D) * D
    n_loc = n_pad // D
    lo, hi = rank * n_loc, (rank + 1) * n_loc
    stats = DistStats(kernel_impl=impl)

    lat_p = np.full((n_pad, n_pad), BIG, np.float32)
    lat_p[:n, :n] = finite_lat(rg)
    bw_p = np.zeros((n_pad, n_pad), np.float32)
    bw_p[:n, :n] = rg.bw
    cap_p = _pad_to(rg.cap.astype(np.float32), n_pad, 0.0)
    prefix = creq_prefix(df).astype(np.float32)
    breq_k = np.concatenate([[BIG], df.breq, [BIG]]).astype(np.float32)
    finite_edge = np.isfinite(rg.lat) & ~np.eye(n, dtype=bool)
    out_deg = _pad_to(finite_edge.sum(1).astype(np.int32), n_pad, 0)
    owner = np.arange(n_pad) // n_loc
    cross = finite_edge & (owner[:n, None] != owner[None, :n])
    out_deg_x = _pad_to(cross.sum(1).astype(np.int32), n_pad, 0)
    C0 = np.full((n_pad, K), BIG, np.float32)
    C0[df.src, 0] = 0.0
    T = max_rounds or max(n - 1, 1)

    # this rank's block: state rows lo:hi, their capacities and degrees, and
    # the incoming link columns lo:hi (one contiguous copy per solve)
    C = to_device(C0[lo:hi], dev)
    par_v = torch.full((n_loc, K), -1, dtype=torch.int32, device=dev)
    par_j = torch.full((n_loc, K), -1, dtype=torch.int32, device=dev)
    cap = to_device(cap_p[lo:hi], dev)
    lat_cols = to_device(lat_p[:, lo:hi], dev)
    bw_cols = to_device(bw_p[:, lo:hi], dev)
    prefix_t = to_device(prefix, dev)
    breq_t = to_device(breq_k, dev)
    deg = to_device(np.stack([out_deg[lo:hi], out_deg_x[lo:hi]], axis=1)
                    .astype(np.float32), dev)  # (n_loc, 2)
    msgs = torch.zeros(2, dtype=torch.float32, device=dev)

    t, changed = 0, True
    while t < T and changed:
        C, par_v, par_j, msgs, changed = _dist_body(
            C, par_v, par_j, msgs, cap, lat_cols, bw_cols, prefix_t, breq_t,
            deg, move=move, group=group, D=D)
        t += 1
        # The loop condition is read on the host once per superstep (a
        # device sync); the batched DP keeps it on the device instead.
        changed = bool(changed)

    C, par_v, par_j = _gather_rows(group, D, C, par_v, par_j)
    C = C[:n].cpu().numpy()
    par_v, par_j = par_v[:n].cpu().numpy(), par_j[:n].cpu().numpy()
    msg_tot, msg_x = (float(x) for x in msgs.cpu().numpy())
    stats.messages_total = int(msg_tot)
    stats.messages_cross_device = int(msg_x)
    stats.supersteps = stats.rounds = t
    stats.max_set_size = int(np.sum(C < BIG / 2))

    # finish: min over j<p with capacity for the tail on dst
    feas = (np.arange(p + 1) < p) & (
        prefix[p] - prefix <= float(rg.cap[df.dst]) + EPS_CAP_F32
    )
    final = np.where(feas, C[df.dst], BIG)
    best_j = int(np.argmin(final))
    m = reconstruct_mapping(
        rg, df, par_v, par_j, float(final[best_j]), best_j,
        validate=validate, stats=stats,
    )
    return m, stats
