"""Shared problem machinery for the port's solver backends.

Port of ``repro/core/problem.py``.  The constants are copied exactly (the
kernel and the plain version compare against them bit for bit); the tensor
builders return float32/int32 ``torch`` tensors on the requested device.

Requests of mixed length ``p`` share one batched DP by padding the capacity
prefix (repeat last value: trailing ghost nodes cost nothing) and the
bandwidth requirements (``BIG``: ghost dataflow edges admit no move), with
the true length carried as a per-request ``p_eff`` read only by the final
reduction at ``dst``.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import DataflowPath, ResourceGraph

BIG = np.float32(1e18)  # finite stand-in for +inf inside kernels (min-plus safe)

# Feasibility slacks.  Scalar/python relaxations accumulate in float64 and use
# the tight slack; float32 tensor paths and end-to-end mapping validation use
# the loose one (float32 prefix sums lose ~7 digits).  ``EPS_COST`` is the
# strict-improvement tie-break of the python relaxations; ``EPS_IMPROVE`` the
# monotone-update threshold of the float32 DP.
EPS_CAP = 1e-9
EPS_CAP_F32 = 1e-6
EPS_BW = 1e-9
EPS_COST = 1e-12
EPS_IMPROVE = 1e-9


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    something else.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to ``device`` without synchronizing the host with
    the device: CUDA copies go through pinned memory and are enqueued on the
    current stream, so dispatch never waits on supersteps already queued."""
    t = torch.from_numpy(np.array(arr, order="C"))  # a private host copy
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def creq_prefix(df: DataflowPath) -> np.ndarray:
    """(p+1,) float64 prefix sums of compute requirements; prefix[k]-prefix[j]
    is the load of placing dataflow nodes j..k-1 on one resource node."""
    return np.concatenate([[0.0], np.cumsum(df.creq)])


def make_cap_ok(rg: ResourceGraph, df: DataflowPath):
    """The capacity window test shared by all scalar relaxations:
    ``cap_ok(j, k, v)`` — can dataflow nodes j..k-1 be placed on node v?"""
    prefix = creq_prefix(df)

    def cap_ok(j: int, k: int, v: int) -> bool:
        return prefix[k] - prefix[j] <= float(rg.cap[v]) + EPS_CAP

    return cap_ok


def finite_lat(rg: ResourceGraph) -> np.ndarray:
    """Latency matrix with INF -> BIG and a BIG diagonal (moves never stay
    in place; the place step handles co-location)."""
    lat = np.where(np.isfinite(rg.lat), rg.lat, BIG).astype(np.float32)
    np.fill_diagonal(lat, BIG)
    return lat


def graph_tensors_of(rg: ResourceGraph, device) -> dict:
    """Float32 ``{cap, bw, lat}`` network tensors on ``device``."""
    return dict(
        cap=to_device(np.asarray(rg.cap, np.float32), device),
        bw=to_device(np.asarray(rg.bw, np.float32), device),
        lat=to_device(finite_lat(rg), device),
    )


def problem_tensors(rg: ResourceGraph, df: DataflowPath, *, device,
                    graph_tensors: dict | None = None) -> dict:
    """Dense float32 tensors of one request on ``device``.  INF -> BIG.

    ``graph_tensors`` (``{cap, bw, lat}``, e.g. from
    :meth:`repro_torch.core.residual.ResidualState.device_tensors`)
    substitutes already-resident network tensors for the host upload."""
    dev = torch.device(device)
    if graph_tensors is None:
        graph_tensors = graph_tensors_of(rg, dev)
    return dict(
        cap=graph_tensors["cap"],
        bw=graph_tensors["bw"],
        lat=graph_tensors["lat"],
        prefix=to_device(creq_prefix(df).astype(np.float32), dev),
        breq=to_device(df.breq.astype(np.float32), dev),
        src=to_device(np.int32(df.src), dev),
        dst=to_device(np.int32(df.dst), dev),
        p_eff=to_device(np.int32(df.p), dev),
    )


def pad_request(df: DataflowPath, p_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad one request's (prefix, breq) to the batch-wide ``p_max``.

    The prefix repeats its final value (ghost nodes require no compute) and
    breq pads with BIG (no link can carry a ghost dataflow edge, so the DP
    never extends a route past the request's true sink column).  Columns
    beyond ``p_eff`` are unreachable garbage the final reduction never reads.
    """
    p = df.p
    assert p <= p_max
    prefix = creq_prefix(df).astype(np.float32)
    prefix = np.concatenate([prefix, np.full(p_max - p, prefix[-1], np.float32)])
    breq = np.concatenate(
        [df.breq.astype(np.float32), np.full(p_max - p, BIG, np.float32)]
    )
    return prefix, breq[: p_max - 1]


def stack_requests(rg: ResourceGraph, dfs: list[DataflowPath],
                   pad_to: int | None = None, *, device, view=None,
                   graph_tensors: dict | None = None) -> tuple[dict, int]:
    """Stack mixed-``p`` requests against one shared resource network into
    the batched tensor dict for the batched DP.  Returns (tensors, p_max);
    link tensors are shared, per-request tensors are stacked on axis 0.

    ``pad_to`` pads the batch dimension to a fixed size by repeating the
    last request (a well-formed dummy problem), so padded batches give the
    same results for the real rows.  Callers must ignore results beyond
    ``len(dfs)``.

    ``view`` compacts a global problem into the view's local id space: the
    node dimension of every stacked tensor is the region-local ``n_r``, not
    the global ``n`` (see :mod:`repro_torch.core.compact`).

    ``graph_tensors`` injects device-resident ``{cap, bw, lat}`` (already in
    whatever id space ``dfs`` use — incompatible with ``view`` compaction).
    """
    assert dfs
    if view is not None:
        assert graph_tensors is None, "view compaction vs device tensors"
        rg = view.compact_graph(rg)
        dfs = [view.compact_df(d) for d in dfs]
    dev = torch.device(device)
    reqs = list(dfs)
    if pad_to is not None:
        assert pad_to >= len(reqs)
        reqs += [reqs[-1]] * (pad_to - len(reqs))
    p_max = max(d.p for d in reqs)
    padded = [pad_request(d, p_max) for d in reqs]
    if graph_tensors is None:
        graph_tensors = graph_tensors_of(rg, dev)
    ints = np.array([[d.src, d.dst, d.p] for d in reqs], np.int32)
    tensors = dict(
        cap=graph_tensors["cap"],
        bw=graph_tensors["bw"],
        lat=graph_tensors["lat"],
        prefix=to_device(np.stack([pr for pr, _ in padded]), dev),
        breq=to_device(np.stack([bq for _, bq in padded]), dev),
        src=to_device(ints[:, 0], dev),
        dst=to_device(ints[:, 1], dev),
        p_eff=to_device(ints[:, 2], dev),
    )
    return tensors, p_max
