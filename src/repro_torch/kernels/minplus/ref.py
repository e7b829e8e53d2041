"""Plain-PyTorch oracle for the bandwidth-masked min-plus relaxation (move
step).

Port of ``repro/kernels/minplus/ref.py``, under its names and signature:

    C[w, k]  = min_v  P[v, k] + lat[v, w]   s.t.  bw[v, w] >= breq_k[k]
    pv[w, k] = argmin_v (first minimal v, ties broken towards smaller v)

Shapes: P (n, K), lat (n, n), bw (n, n), breq_k (K,), the k-indexed
thresholds.  Infeasible entries hold BIG.  ``ops.masked_minplus_ref``
takes the raw (p-1,) requirement vector instead and builds ``breq_k``
first, as the reference's ``ops.py`` does; both end in
:func:`masked_minplus_plain`.
"""
from __future__ import annotations

from ...core.problem import BIG  # noqa: F401
from .minplus import masked_minplus_plain


def masked_minplus_ref(P, lat, bw, breq_k):
    """(C (n, K) float32, pv (n, K) int32), k by k."""
    return masked_minplus_plain(P, lat, bw, breq_k)
