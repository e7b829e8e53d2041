"""Bandwidth-masked (min,+) move step: hand-written CUDA kernel + plain
PyTorch version.

Port of ``repro/kernels/minplus/minplus.py`` (``masked_minplus_pallas``) and
its oracle ``minplus/ref.py``, for a rectangular link block: P (n_v, K),
lat and bw (n_v, n_w), breq_k (K,), float32, unpadded:

    C[w, k]  = min_{v, bw[v,w] >= breq_k[k]}  min(P[v, k] + lat[v, w], BIG)
    pv[w, k] = the first (smallest) minimal v;  no feasible v -> BIG, 0

The square case is the reference's op; the decentralized engine
(``core/distributed.py``) passes the link columns one rank owns.  The kernel
is ``csrc/masked_minplus.cu`` (CUDA C++ for ``sm_90a``), built at first use
by ``repro_torch.kernels._build``: one launch per call, whose shape
:func:`plan_move` chooses (a plain function; on a card it asks CUDA how
many thread block clusters fit).  :func:`masked_minplus_cuda` launches
it (CUDA tensors only) and counts the launch in ``LAUNCHES``;
:func:`masked_minplus_plain` is a torch transcription of the reference's
``masked_minplus_ref``, and the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from ...core.problem import BIG
from .._build import KernelLibrary, check_launch, check_tensor, load, sm_count

LAUNCHES = 0  # kernel launches (one per masked_minplus_cuda call)

SOURCE = Path(__file__).resolve().parent / "csrc" / "masked_minplus.cu"

# The kernel's fixed shape (csrc/masked_minplus.cu): 256 threads, each with
# 4 adjacent columns w x kt running minima; a block covers w_tile columns
# (W_TILES) and 256 / (w_tile / 4) v lanes; lat/bw stream through a ring of
# stages of STAGE_ELEMS elements each (STAGE_ELEMS / w_tile rows).
THREADS = 256
W_TILES = (64, 32, 16)
STAGE_ELEMS = 2048
MAX_KT = 9  # k per block; a larger K is cut into chunks
V_ALIGN = 32  # v per split is a multiple of this
BLOCKS_PER_SM = 2  # __launch_bounds__(256, 2)
MAX_SPLITS = 16  # a thread block cluster, above 8 only as non-portable
MIN_STAGES, MAX_STAGES = 3, 4
SMEM_PER_SM = 233472  # sm_90: 228 KB, 1 KB of it reserved per block
MAX_GRID = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch shape of the move kernel for (n_v, n_w, K): one launch
    of ``blocks`` blocks, the v splits of each output tile one cluster."""

    n_v: int
    n_w: int
    K: int
    kt: int  # k per block (a template instance)
    kchunks: int  # blocks along k: chunks of kt cover K
    w_tile: int  # columns per block
    splits: int  # blocks along v: one cluster per output tile
    v_chunk: int  # v per split, a multiple of V_ALIGN
    stages: int
    w_tiles: int
    smem: int  # dynamic shared memory per block, bytes

    @property
    def blocks(self) -> int:
        return self.w_tiles * self.kchunks * self.splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padded(kt: int) -> int:
    return (kt + 3) & ~3


def smem_bytes(kt: int, w_tile: int, stages: int) -> int:
    """The kernel's ``Layout(kt, w_tile, stages).bytes()``: the split
    minima the block receives from its cluster, then a ring of ``stages``
    stages of lat, bw and P rows (or every thread's 4 * kt minima and
    argmins for the lane merge, if that is larger)."""
    res = _padded(2 * (w_tile * kt + MAX_SPLITS - 1))
    stage = 2 * STAGE_ELEMS + (STAGE_ELEMS // w_tile) * _padded(kt)
    merge = 2 * THREADS * 4 * kt
    return 4 * (res + max(stages * stage, merge))


def _fits(smem: int) -> bool:
    """Two blocks of this dynamic shared memory fit on one SM."""
    return BLOCKS_PER_SM * (smem + 1024) <= SMEM_PER_SM


def plan_move(n_v: int, n_w: int, K: int, sms: int,
              max_clusters=None) -> Plan:
    """Choose the launch for (n_v, n_w, K) on a card with ``sms`` SMs.

    K is cut into ``ceil(K / MAX_KT)`` equal chunks, one per block row, so
    ``kt`` is K itself up to 9 (no dead k).  Each column tile of ``w_tile``
    columns gets ``splits`` blocks along v, one thread block cluster (at
    most ``MAX_SPLITS``), whose partial minima merge in distributed shared
    memory: one launch, no partial buffer in device memory.
    ``max_clusters(kt, w_tile, stages, splits)`` says how many clusters of
    ``splits`` blocks the card holds at once (the kernel asks CUDA);
    by default ``BLOCKS_PER_SM * sms`` slots divided evenly.  Among the
    shapes whose grid has a block for every SM (if any), the plan
    minimises waves x (per-block candidates + one stage of pipeline fill),
    then prefers wider tiles (longer coalesced rows), then fewer splits.
    """
    if min(n_v, n_w, K) < 1:
        raise ValueError(f"empty move: {(n_v, n_w, K)}")
    if max_clusters is None:
        def max_clusters(kt, w_tile, stages, splits):
            return BLOCKS_PER_SM * sms // splits
    kchunks = _cdiv(K, MAX_KT)
    kt = _cdiv(K, kchunks)
    best = None
    for w_tile in W_TILES:
        stages = MAX_STAGES if _fits(smem_bytes(kt, w_tile, MAX_STAGES)) \
            else MIN_STAGES
        base = _cdiv(n_w, w_tile) * kchunks
        for want in range(1, min(MAX_SPLITS, _cdiv(n_v, V_ALIGN)) + 1):
            v_chunk = _cdiv(_cdiv(n_v, want), V_ALIGN) * V_ALIGN
            splits = _cdiv(n_v, v_chunk)
            if splits != want or base * splits > MAX_GRID:
                continue
            resident = max_clusters(kt, w_tile, stages, splits) * splits
            if resident < 1:
                continue
            cost = _cdiv(base * splits, resident) * (
                w_tile * v_chunk + STAGE_ELEMS)
            key = (base * splits < sms, cost, -w_tile, splits)
            if best is None or key < best[0]:
                best = (key, w_tile, splits, v_chunk, stages)
    if best is None:
        raise ValueError(f"no launch of the move kernel fits {(n_v, n_w, K)}")
    _, w_tile, splits, v_chunk, stages = best
    return Plan(n_v, n_w, K, kt, kchunks, w_tile, splits, v_chunk, stages,
                _cdiv(n_w, w_tile), smem_bytes(kt, w_tile, stages))


@functools.cache
def _prepare(index: int) -> None:
    """Set the kernel's shared-memory and cluster attributes on a device,
    once (the launch itself sets none)."""
    kl = load_library()
    with torch.cuda.device(index):
        check_launch(kl, kl.lib.masked_minplus_prepare(), "masked_minplus")


@functools.cache
def _plan_on(index: int, n_v: int, n_w: int, K: int) -> Plan:
    """:func:`plan_move` with the card's own cluster occupancy, once per
    device and shape."""
    _prepare(index)
    lib = load_library().lib

    def max_clusters(kt, w_tile, stages, splits):
        with torch.cuda.device(index):
            got = lib.masked_minplus_max_clusters(kt, w_tile, stages, splits)
        if got < 0:
            raise RuntimeError(f"cluster occupancy query failed ({got})")
        return got

    return plan_move(n_v, n_w, K, sm_count(index), max_clusters)


@functools.cache
def load_library() -> KernelLibrary:
    kl = load(SOURCE)
    fn = kl.lib.masked_minplus_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kl.lib.masked_minplus_max_clusters.argtypes = [ctypes.c_int] * 4
    kl.lib.masked_minplus_max_clusters.restype = ctypes.c_int
    kl.lib.masked_minplus_smem.argtypes = [ctypes.c_int] * 3
    kl.lib.masked_minplus_smem.restype = ctypes.c_int
    kl.lib.masked_minplus_prepare.argtypes = []
    kl.lib.masked_minplus_prepare.restype = ctypes.c_int
    return kl


def masked_minplus_cuda(P, lat, bw, breq_k):
    """Launch the kernel on CUDA tensors (one launch, planned once per
    shape).  Returns ``(C (n_w, K), pv)``."""
    global LAUNCHES
    n_v, K = P.shape
    dev = P.device
    if not P.is_cuda:
        raise ValueError(f"masked_minplus_cuda needs CUDA tensors, got {dev}")
    n_w = lat.shape[-1]
    check_tensor("P", P, torch.float32, (n_v, K), dev)
    check_tensor("lat", lat, torch.float32, (n_v, n_w), dev)
    check_tensor("bw", bw, torch.float32, (n_v, n_w), dev)
    check_tensor("breq_k", breq_k, torch.float32, (K,), dev)
    if max(n_v * n_w, n_v * K, n_w * K) >= 2**31:
        raise ValueError(f"block too large for the kernel: {(n_v, n_w, K)}")
    C = torch.empty((n_w, K), dtype=torch.float32, device=dev)
    pv = torch.empty((n_w, K), dtype=torch.int32, device=dev)
    if n_w * K == 0:
        return C, pv
    kl = load_library()
    p = _plan_on(dev.index if dev.index is not None
                 else torch.cuda.current_device(), n_v, n_w, K)
    with torch.cuda.device(dev):
        err = kl.lib.masked_minplus_launch(
            P.data_ptr(), lat.data_ptr(), bw.data_ptr(), breq_k.data_ptr(),
            C.data_ptr(), pv.data_ptr(), n_v, n_w, K, p.kt, p.w_tile, p.splits, p.v_chunk, p.stages,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(kl, err, "masked_minplus")
    LAUNCHES += 1
    return C, pv


def masked_minplus_plain(P, lat, bw, breq_k):
    """Transcription of ``masked_minplus_ref``: per k, a (v, w) candidate
    slab reduced over v (first minimal v on ties)."""
    best, arg = [], []
    for k in range(P.shape[1]):
        cand = torch.where(bw >= breq_k[k], P[:, k, None] + lat, float(BIG))
        cand = torch.clamp(cand, max=float(BIG))
        m, a = torch.min(cand, dim=0)
        best.append(m)
        arg.append(a.to(torch.int32))
    return torch.stack(best, dim=1), torch.stack(arg, dim=1)
