"""Plain-PyTorch oracle for the capacity-window place step.

Port of ``repro/kernels/place/ref.py``, under its names and signature:

    P[v, k]  = min_{j <= k,  prefix[k] - prefix[j] <= cap[v]}  C[v, j]
    pj[v, k] = argmin j (first minimal)

Infeasible = BIG.  The same function as ``ops.place_window_ref``.
"""
from __future__ import annotations

from ...core.problem import BIG, EPS_CAP_F32  # noqa: F401
from .place import place_window_plain


def place_window_ref(C, cap, prefix):
    """C (n, K), cap (n,), prefix (K,) -> (P (n, K), pj (n, K) int32)."""
    return place_window_plain(C, cap, prefix)
