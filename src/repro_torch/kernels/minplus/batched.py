"""Batched fused DP superstep: hand-written CUDA kernel + plain PyTorch version.

Port of ``repro/kernels/minplus/batched.py``.  One superstep for B requests
against one shared network (shapes unpadded):

    place:  P[b,v,k]  = min_{j<=k, prefix[b,k]-prefix[b,j] <= cap[v]+EPS} C[b,v,j]
    move:   C'[b,w,k] = min_{v, bw[v,w] >= breq_k[b,k]}  P[b,v,k] + lat[v,w]
    update: Cn = where(C' < C - EPS_IMPROVE, C', C)   (+ parent pointers)

Place ties go to the largest j, move ties to the first v.  The kernel is
``csrc/batched_superstep.cu`` (CUDA C++ for ``sm_90a``), built at first use
by ``repro_torch.kernels._build`` and loaded with ``ctypes``.

:func:`batched_superstep` launches the kernel for CUDA tensors and uses the
plain version for CPU tensors.  :func:`batched_superstep_plain` is a torch
transcription of the reference's ``batched_superstep_ref``; the kernel
agrees with it bit for bit (C, par_v, par_j).  ``LAUNCHES`` counts kernel
supersteps launched.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...core.problem import BIG, EPS_CAP_F32, EPS_IMPROVE
from .._build import KernelLibrary, check_launch, load
from .._build import check_tensor as _check

LAUNCHES = 0  # kernel supersteps launched (one per wrapper call on CUDA)

SOURCE = Path(__file__).resolve().parent / "csrc" / "batched_superstep.cu"


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel's shared library."""
    kl = load(SOURCE)
    fn = kl.lib.batched_superstep_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return kl


def batched_superstep(C, par_v, par_j, lat, bw, cap, prefix, breq_k, *,
                      flags=None):
    """One fused superstep.  CUDA tensors launch the kernel; CPU tensors use
    :func:`batched_superstep_plain`.  Returns ``(Cn, par_vn, par_jn)``.

    ``flags`` (int32 ``[t, active, changed, max_rounds]`` on the same device)
    makes the superstep conditional on ``active`` and advances the control
    word on the device, so a caller can enqueue many supersteps and read the
    round count once (see :func:`advance_flags`)."""
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
    if B * K * n >= 2**31:
        raise ValueError(f"state too large for the kernel: {(B, n, K)}")
    kl = load_library()
    Cn = torch.empty_like(C)
    pvn = torch.empty_like(par_v)
    pjn = torch.empty_like(par_j)
    P = torch.empty((B * K, n), dtype=torch.float32, device=dev)
    Pj = torch.empty((B * K, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # launch on the tensors' device and stream
        err = kl.lib.batched_superstep_launch(
            C.data_ptr(), par_v.data_ptr(), par_j.data_ptr(), lat.data_ptr(),
            bw.data_ptr(), cap.data_ptr(), prefix.data_ptr(),
            breq_k.data_ptr(), Cn.data_ptr(), pvn.data_ptr(), pjn.data_ptr(),
            P.data_ptr(), Pj.data_ptr(),
            None if flags is None else flags.data_ptr(), B, n, K,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(kl, err, "batched_superstep")
    LAUNCHES += 1
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
