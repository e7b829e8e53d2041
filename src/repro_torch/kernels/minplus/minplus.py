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
by ``repro_torch.kernels._build``.  :func:`masked_minplus_cuda` launches it
(CUDA tensors only) and counts the launch in ``LAUNCHES``;
:func:`masked_minplus_plain` is a torch transcription of the reference's
``masked_minplus_ref``, and the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...core.problem import BIG
from .._build import KernelLibrary, check_launch, check_tensor, load, sm_count

LAUNCHES = 0  # kernel launches (one per masked_minplus_cuda call)

SOURCE = Path(__file__).resolve().parent / "csrc" / "masked_minplus.cu"


@functools.cache
def load_library() -> KernelLibrary:
    kl = load(SOURCE)
    fn = kl.lib.masked_minplus_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kl.lib.masked_minplus_splits.argtypes = [ctypes.c_int] * 4
    kl.lib.masked_minplus_splits.restype = ctypes.c_int
    return kl


def masked_minplus_cuda(P, lat, bw, breq_k):
    """Launch the kernel on CUDA tensors.  Returns ``(C (n_w, K), pv)``."""
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
    kl = load_library()
    sms = sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    splits = kl.lib.masked_minplus_splits(n_v, n_w, K, sms)
    C = torch.empty((n_w, K), dtype=torch.float32, device=dev)
    pv = torch.empty((n_w, K), dtype=torch.int32, device=dev)
    part_c = part_v = None
    if splits > 1:
        part_c = torch.empty((splits, n_w, K), dtype=torch.float32, device=dev)
        part_v = torch.empty((splits, n_w, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kl.lib.masked_minplus_launch(
            P.data_ptr(), lat.data_ptr(), bw.data_ptr(), breq_k.data_ptr(),
            C.data_ptr(), pv.data_ptr(),
            None if part_c is None else part_c.data_ptr(),
            None if part_v is None else part_v.data_ptr(), n_v, n_w, K, sms,
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
