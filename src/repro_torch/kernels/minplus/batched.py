"""Batched fused DP superstep: hand-written CUDA kernel + plain PyTorch version.

Port of ``repro/kernels/minplus/batched.py``.  One superstep for B requests
against one shared network (shapes unpadded):

    place:  P[b,v,k]  = min_{j<=k, prefix[b,k]-prefix[b,j] <= cap[v]+EPS} C[b,v,j]
    move:   C'[b,w,k] = min_{v, bw[v,w] >= breq_k[b,k]}  P[b,v,k] + lat[v,w]
    update: Cn = where(C' < C - EPS_IMPROVE, C', C)   (+ parent pointers)

Place ties go to the largest j, move ties to the first v.  The kernel is
``csrc/batched_superstep.cu`` (CUDA C++ for ``sm_90a``), one launch per
superstep, built at first use by ``repro_torch.kernels._build`` and loaded
with ``ctypes``.  :func:`plan_superstep` chooses its tile shape and how many
blocks (one thread block cluster) split the v range; a :class:`Workspace`
holds the plan and the kernel's retire ticket and is reused by every
superstep of a relaxation.

:func:`batched_superstep` launches the kernel for CUDA tensors and uses the
plain version for CPU tensors.  :func:`batched_superstep_plain` is a torch
transcription of the reference's ``batched_superstep_ref``; the kernel
agrees with it bit for bit (C, par_v, par_j).  ``LAUNCHES`` counts kernel
supersteps launched, ``LAUNCHES_BY_B`` the same keyed by batch size and
``LAUNCHES_BY_SHAPE`` keyed by (B, n, K).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from ...core.problem import BIG, EPS_CAP_F32, EPS_IMPROVE
from .._build import KernelLibrary, check_launch, load, sm_count
from .._build import check_tensor as _check

LAUNCHES = 0  # kernel supersteps launched (one per wrapper call on CUDA)
LAUNCHES_BY_B: dict[int, int] = {}  # the same supersteps, keyed by batch B
LAUNCHES_BY_SHAPE: dict[tuple, int] = {}  # ... and keyed by (B, n, K)

SOURCE = Path(__file__).resolve().parent / "csrc" / "batched_superstep.cu"

# The kernel's fixed tile (csrc/batched_superstep.cu): 256 threads as 16
# columns of 4 w x 16 rows, each row one request of the block's tb and one
# of its 16/tb v lanes; v staged 32 at a time; k per thread from KT_SIZES.
W_TILE = 64
ROWS = 16
THREADS = 256
V_TILE = 32
KT_SIZES = (2, 3, 4, 6, 9)
BLOCKS_PER_SM = 2  # __launch_bounds__(256, 2)
MAX_SPLITS = 16  # a thread block cluster, above 8 only as non-portable
MIN_STAGES, MAX_STAGES = 3, 4
SMEM_PER_SM = 233472  # sm_90: 228 KB, 1 KB of it reserved per block
MAX_GRID = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch shape of the superstep kernel for (B, n, K)."""

    B: int
    n: int
    K: int
    kt: int  # k per thread (a template instance)
    kchunk: int  # k per block (<= kt); kchunks blocks cover K
    kchunks: int
    tb: int  # requests per block
    tv: int  # v lanes per block, tb * tv == ROWS
    splits: int  # blocks along v: one cluster per output tile
    v_chunk: int  # v per split, a multiple of V_TILE
    stages: int  # v tiles of copies in flight (2 to MAX_STAGES)
    w_tiles: int
    b_tiles: int
    smem: int  # dynamic shared memory per block, bytes

    @property
    def blocks(self) -> int:
        return self.w_tiles * self.b_tiles * self.kchunks * self.splits


def smem_bytes(kt: int, tb: int, K: int, stages: int) -> int:
    """The kernel's ``Layout(kt, tb, K, stages).bytes()``: a ring of
    ``stages`` tiles of lat/bw, cap and C rows, two tiles of P records
    (values and packed argmins) and prefix, or the lane merge if that is
    larger."""
    rec = 2 * ((kt + 3) & ~3)
    stage = (stages * (2 * V_TILE * W_TILE + V_TILE + tb * V_TILE * K)
             + 2 * V_TILE * (tb * rec + 4) + tb * K)
    merge = 2 * THREADS * (4 * kt + 1)
    return 4 * max(stage, merge)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_superstep(B: int, n: int, K: int, sms: int,
                   max_clusters=None) -> Plan:
    """Choose the launch for (B, n, K) on a card with ``sms`` SMs.

    Each thread keeps ``kt`` pairs x 4 w of running minima, so K is cut
    into chunks of at most ``max(KT_SIZES)``.  Blocks hold ``tb`` requests
    and ``16 / tb`` v lanes; when that gives too few blocks to fill the
    card, the v range is split across the blocks of a cluster (at most
    ``MAX_SPLITS``).  ``max_clusters(kt, tb, K, stages, splits)`` says how
    many clusters of ``splits`` blocks the card holds at once (the kernel
    asks the driver); by default the SMs' slots, ``BLOCKS_PER_SM * sms``,
    divided evenly.  Among the shapes whose shared memory lets two blocks
    share an SM, the plan minimises waves x (per-block work + one stage),
    then prefers fewer splits (fewer partial minima to merge), then larger
    ``tb`` (fewer lat/bw reads).  Each block keeps 4 v tiles of copies in
    flight where the shared memory allows, else 3.
    """
    if min(B, n, K) < 1:
        raise ValueError(f"empty superstep: {(B, n, K)}")
    if max_clusters is None:
        def max_clusters(kt, tb, K, stages, splits):
            return BLOCKS_PER_SM * sms // splits
    kchunks = _cdiv(K, max(KT_SIZES))
    kchunk = _cdiv(K, kchunks)
    kt = min(x for x in KT_SIZES if x >= kchunk)
    w_tiles = _cdiv(n, W_TILE)
    best = None
    for tb in (16, 8, 4, 2, 1):
        if (tb > B and tb > 1) or not _fits(smem_bytes(kt, tb, K, 3)):
            continue
        base = w_tiles * _cdiv(B, tb) * kchunks
        for want in range(1, min(MAX_SPLITS, _cdiv(n, V_TILE)) + 1):
            v_chunk = _cdiv(_cdiv(n, want), V_TILE) * V_TILE
            splits = _cdiv(n, v_chunk)
            if splits != want or base * splits > MAX_GRID:
                continue
            stages = 4 if _fits(smem_bytes(kt, tb, K, 4)) else 3
            resident = max_clusters(kt, tb, K, stages, splits) * splits
            if resident < 1:
                continue
            cost = _cdiv(base * splits, resident) * tb * (v_chunk + V_TILE)
            key = (cost, splits, -tb)
            if best is None or key < best[0]:
                best = (key, tb, splits, v_chunk, stages)
    if best is None:
        raise ValueError(f"no launch of the superstep kernel fits {(B, n, K)}")
    _, tb, splits, v_chunk, stages = best
    return Plan(B, n, K, kt, kchunk, kchunks, tb, ROWS // tb, splits, v_chunk,
                stages, w_tiles, _cdiv(B, tb), smem_bytes(kt, tb, K, stages))


def _fits(smem: int) -> bool:
    """Two blocks of this dynamic shared memory fit on one SM."""
    return BLOCKS_PER_SM * (smem + 1024) <= SMEM_PER_SM


@dataclasses.dataclass(eq=False)
class Workspace:
    """One plan on one device and the kernel's retire ticket (an int32
    zero; the last block of each launch leaves it zero again)."""

    plan: Plan
    ticket: torch.Tensor  # int32 (1,)


def make_workspace(B: int, n: int, K: int, device) -> Workspace:
    """Plan the superstep for (B, n, K) on a CUDA ``device`` and allocate
    its workspace; one workspace serves every superstep of a relaxation."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the superstep kernel needs a CUDA device, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return Workspace(_plan_on(index, B, n, K),
                     torch.zeros(1, dtype=torch.int32, device=dev))


@functools.cache
def _plan_on(index: int, B: int, n: int, K: int) -> Plan:
    """:func:`plan_superstep` with the card's own cluster occupancy."""
    lib = load_library().lib

    def max_clusters(kt, tb, K, stages, splits):
        with torch.cuda.device(index):
            got = lib.batched_superstep_max_clusters(kt, tb, K, stages, splits)
        if got < 0:
            raise RuntimeError(f"cluster occupancy query failed ({got})")
        return got

    return plan_superstep(B, n, K, sm_count(index), max_clusters)


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel's shared library."""
    kl = load(SOURCE)
    fn = kl.lib.batched_superstep_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name in ("smem", "max_clusters"):
        fn = getattr(kl.lib, f"batched_superstep_{name}")
        fn.argtypes = [ctypes.c_int] * (4 if name == "smem" else 5)
        fn.restype = ctypes.c_int
    return kl


def batched_superstep(C, par_v, par_j, lat, bw, cap, prefix, breq_k, *,
                      flags=None, workspace=None):
    """One fused superstep.  CUDA tensors launch the kernel; CPU tensors use
    :func:`batched_superstep_plain`.  Returns ``(Cn, par_vn, par_jn)``.

    ``flags`` (int32 ``[t, active, changed, max_rounds]`` on the same device)
    makes the superstep conditional on ``active`` and advances the control
    word on the device, so a caller can enqueue many supersteps and read the
    round count once (see :func:`advance_flags`).  ``workspace`` (from
    :func:`make_workspace` for this shape and device) is reused across
    supersteps; None allocates one for this call.  Supersteps that share a
    workspace must run in order on one stream."""
    if not C.is_cuda:
        return plain_superstep(C, par_v, par_j, lat, bw, cap, prefix, breq_k,
                               flags=flags)
    global LAUNCHES
    B, n, K = C.shape
    dev = C.device
    _check("C", C, torch.float32, (B, n, K), dev)
    _check("par_v", par_v, torch.int32, (B, n, K), dev)
    _check("par_j", par_j, torch.int32, (B, n, K), dev)
    _check("lat", lat, torch.float32, (n, n), dev)
    _check("bw", bw, torch.float32, (n, n), dev)
    _check("cap", cap, torch.float32, (n,), dev)
    _check("prefix", prefix, torch.float32, (B, K), dev)
    _check("breq_k", breq_k, torch.float32, (B, K), dev)
    if flags is not None:
        _check("flags", flags, torch.int32, (4,), dev)
    if B * K * n >= 2**31 or n * n >= 2**31:
        raise ValueError(f"state too large for the kernel: {(B, n, K)}")
    if workspace is None:
        workspace = make_workspace(B, n, K, dev)
    plan = workspace.plan
    if (plan.B, plan.n, plan.K) != (B, n, K):
        raise ValueError(f"workspace planned for {(plan.B, plan.n, plan.K)}, "
                         f"superstep is {(B, n, K)}")
    _check("workspace.ticket", workspace.ticket, torch.int32, (1,), dev)
    kl = load_library()
    Cn = torch.empty_like(C)
    pvn = torch.empty_like(par_v)
    pjn = torch.empty_like(par_j)
    with torch.cuda.device(dev):  # launch on the tensors' device and stream
        err = kl.lib.batched_superstep_launch(
            C.data_ptr(), par_v.data_ptr(), par_j.data_ptr(), lat.data_ptr(),
            bw.data_ptr(), cap.data_ptr(), prefix.data_ptr(),
            breq_k.data_ptr(), Cn.data_ptr(), pvn.data_ptr(), pjn.data_ptr(),
            None if flags is None else flags.data_ptr(),
            workspace.ticket.data_ptr(), B, n, K, plan.kt,
            plan.kchunk, plan.tb, plan.splits, plan.v_chunk, plan.stages,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(kl, err, "batched_superstep")
    LAUNCHES += 1
    LAUNCHES_BY_B[B] = LAUNCHES_BY_B.get(B, 0) + 1
    LAUNCHES_BY_SHAPE[B, n, K] = LAUNCHES_BY_SHAPE.get((B, n, K), 0) + 1
    return Cn, pvn, pjn


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the card's cross-check)
# ---------------------------------------------------------------------------

_BIG = float(BIG)


def _place_plain(C, cap, prefix):
    """Transcription of the reference's ``_place_batched_ref``: descending
    j with a strict ``<`` (ties keep the largest j).  C (B, n, K)."""
    B, n, K = C.shape
    P = torch.full_like(C, _BIG)
    pj = torch.zeros(C.shape, dtype=torch.int32, device=C.device)
    k_idx = torch.arange(K, device=C.device)
    cap_eps = cap + EPS_CAP_F32
    for x in range(K):
        j_idx = k_idx - x
        valid = j_idx >= 0
        j_cl = j_idx.clamp(min=0)
        shifted = torch.where(valid[None, None, :], torch.roll(C, x, dims=2),
                              _BIG)
        block = prefix - prefix[:, j_cl]
        feas = valid[None, None, :] & (
            block[:, None, :] <= cap_eps[None, :, None])
        cand = torch.where(feas, shifted, _BIG)
        upd = cand < P
        P = torch.where(upd, cand, P)
        pj = torch.where(upd, j_cl.to(torch.int32)[None, None, :], pj)
    return P, pj


def _move_plain(P, lat, bw, breq_k):
    """Transcription of ``_move_batched_ref``: per k column, a (B, w, v)
    candidate slab reduced over v (first v on ties)."""
    latT = lat.T
    bwT = bw.T
    best, arg = [], []
    for k in range(P.shape[2]):
        cand = torch.where(bwT[None, :, :] >= breq_k[:, k, None, None],
                           latT[None, :, :] + P[:, None, :, k], _BIG)
        m, a = torch.min(cand, dim=2)
        best.append(m)
        arg.append(a.to(torch.int32))
    return torch.stack(best, dim=2), torch.stack(arg, dim=2)


def batched_superstep_plain(C, par_v, par_j, lat, bw, cap, prefix, breq_k):
    """Fused batched superstep in plain PyTorch, unpadded shapes.  Bit for
    bit the reference's ``batched_superstep_ref``."""
    P, pj = _place_plain(C, cap, prefix)
    Cmv, pv = _move_plain(P, lat, bw, breq_k)
    upd = Cmv < C - EPS_IMPROVE
    pj_of_pv = torch.gather(pj, 1, pv.long())
    return (torch.where(upd, Cmv, C), torch.where(upd, pv, par_v),
            torch.where(upd, pj_of_pv, par_j))


def advance_flags(flags, changed):
    """The control-word update the kernel's finish step does, in torch:
    ``t += active``; ``active &= changed & (t < max_rounds)``."""
    active = flags[1]
    t = flags[0] + active
    still = (active != 0) & changed & (t < flags[3])
    flags.copy_(torch.stack([t, still.to(torch.int32),
                             torch.zeros_like(t), flags[3]]))


def plain_superstep(C, par_v, par_j, lat, bw, cap, prefix, breq_k, *,
                    flags=None):
    """The plain version under the wrapper's calling convention, on any
    device (``kernel_impl="plain"``): with ``flags``, a superstep with
    ``active == 0`` returns its input state unchanged."""
    Cn, pvn, pjn = batched_superstep_plain(C, par_v, par_j, lat, bw, cap,
                                           prefix, breq_k)
    if flags is None:
        return Cn, pvn, pjn
    act = flags[1] != 0
    # the EPS_IMPROVE update is monotone, so any change is a decrease
    advance_flags(flags, (Cn < C).any())
    return (torch.where(act, Cn, C), torch.where(act, pvn, par_v),
            torch.where(act, pjn, par_j))
