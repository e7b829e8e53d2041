"""Public op: bandwidth-masked min-plus relaxation (CUDA kernel or plain
version).

Port of ``repro/kernels/minplus/ops.py``.  ``masked_minplus(P, lat, bw,
breq)`` takes the raw (p-1,) dataflow-edge requirement vector and builds
the k-indexed thresholds (BIG at k = 0 and past the last edge).  It
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors; ``masked_minplus_ref`` is the plain version.
"""
from __future__ import annotations

import torch

from ...core.problem import BIG
from .minplus import masked_minplus_cuda, masked_minplus_plain


def _breq_k(breq, K):
    big = torch.full((1,), float(BIG), dtype=torch.float32, device=breq.device)
    tail = torch.full((K - 1 - breq.shape[0],), float(BIG),
                      dtype=torch.float32, device=breq.device)
    return torch.cat([big, breq.to(torch.float32), tail])


def masked_minplus(P, lat, bw, breq):
    """Move step: returns (C' (n, K) float32, pv (n, K) int32)."""
    bq = _breq_k(breq, P.shape[1])
    if P.is_cuda:
        return masked_minplus_cuda(P, lat, bw, bq)
    return masked_minplus_plain(P, lat, bw, bq)


def masked_minplus_ref(P, lat, bw, breq):
    return masked_minplus_plain(P, lat, bw, _breq_k(breq, P.shape[1]))
