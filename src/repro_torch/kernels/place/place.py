"""Capacity-window place step: hand-written CUDA kernel + plain PyTorch version.

Port of ``repro/kernels/place/place.py`` (``place_window_pallas``) and its
oracle ``place/ref.py``.  For C (n, K), cap (n,), prefix (K,), float32:

    P[v, k]  = min_{j <= k, prefix[k] - prefix[j] <= cap[v] + EPS} C[v, j]
    pj[v, k] = the first (smallest) minimal j;  no feasible j -> BIG, 0

The kernel is ``csrc/place_window.cu`` (CUDA C++ for ``sm_90a``), built at
first use by ``repro_torch.kernels._build``.  :func:`place_window_cuda`
launches it (CUDA tensors only) and counts the launch in ``LAUNCHES``;
:func:`place_window_plain` is a torch transcription of the reference's
``place_window_ref``, and the two agree bit for bit.  The DP's place step
keeps the largest j instead, so this kernel serves only the op
:func:`repro_torch.kernels.place.place_window`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...core.problem import BIG, EPS_CAP_F32
from .._build import KernelLibrary, check_launch, check_tensor, load

LAUNCHES = 0  # kernel launches (one per place_window_cuda call)

SOURCE = Path(__file__).resolve().parent / "csrc" / "place_window.cu"


@functools.cache
def load_library() -> KernelLibrary:
    kl = load(SOURCE)
    fn = kl.lib.place_window_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return kl


def place_window_cuda(C, cap, prefix):
    """Launch the kernel on CUDA tensors.  Returns ``(P, pj)``."""
    global LAUNCHES
    n, K = C.shape
    dev = C.device
    if not C.is_cuda:
        raise ValueError(f"place_window_cuda needs CUDA tensors, got {dev}")
    check_tensor("C", C, torch.float32, (n, K), dev)
    check_tensor("cap", cap, torch.float32, (n,), dev)
    check_tensor("prefix", prefix, torch.float32, (K,), dev)
    if n * K >= 2**31:
        raise ValueError(f"state too large for the kernel: {(n, K)}")
    kl = load_library()
    P = torch.empty_like(C)
    pj = torch.empty((n, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kl.lib.place_window_launch(
            C.data_ptr(), cap.data_ptr(), prefix.data_ptr(), P.data_ptr(),
            pj.data_ptr(), n, K, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(kl, err, "place_window")
    LAUNCHES += 1
    return P, pj


def place_window_plain(C, cap, prefix):
    """Transcription of ``place_window_ref``: a (v, k, j) candidate block
    reduced over j, first minimal j on ties."""
    K = C.shape[1]
    j = torch.arange(K, device=C.device)
    block = prefix[None, :, None] - prefix[None, None, :]  # [1, k, j]
    feas = (j[None, None, :] <= j[None, :, None]) & (
        block <= cap[:, None, None] + EPS_CAP_F32)  # [v, k, j]
    cand = torch.where(feas, C[:, None, :], float(BIG))
    P, pj = torch.min(cand, dim=2)
    return P, pj.to(torch.int32)
