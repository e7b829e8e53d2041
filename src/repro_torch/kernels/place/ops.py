"""Public op: capacity-window place step (CUDA kernel or plain version).

Port of ``repro/kernels/place/ops.py``: :func:`place_window` launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors;
``place_window_ref`` is the plain version under the reference's name.
"""
from __future__ import annotations

from .place import place_window_cuda, place_window_plain

place_window_ref = place_window_plain


def place_window(C, cap, prefix):
    """C (n, K), cap (n,), prefix (K,) float32 -> (P (n, K), pj (n, K) int32)."""
    if C.is_cuda:
        return place_window_cuda(C, cap, prefix)
    return place_window_plain(C, cap, prefix)
