"""Carrying state across from the JAX package.

In a mapper, data takes the place of weights: the network and the residual
state a placer has built up.  Both cross as plain numpy arrays, so nothing
here imports the JAX package:

- :func:`graph_from_numpy` builds the port's ``ResourceGraph`` from the
  ``cap``/``bw``/``lat`` arrays of either package's graph;
- :func:`residual_from_snapshot` builds the port's ``ResidualState`` from a
  ``ResidualState.snapshot()`` dict of the reference (or of the port).

A placer of either package restored from the same snapshot admits the next
batch identically.
"""
from __future__ import annotations

import numpy as np

from .graph import ResourceGraph
from .problem import resolve_device
from .residual import ResidualState

SNAPSHOT_KEYS = ("cap", "bw", "node_up", "link_up")


def graph_from_numpy(cap, bw, lat) -> ResourceGraph:
    """The port's ``ResourceGraph`` over float32 copies of the arrays."""
    return ResourceGraph(np.array(cap, np.float32), np.array(bw, np.float32),
                         np.array(lat, np.float32))


def residual_from_snapshot(base_arrays: dict, snap: dict, *,
                           device=None) -> ResidualState:
    """A ``ResidualState`` over the base network ``base_arrays`` (``cap``,
    ``bw``, ``lat``) holding the residual of ``snap``.  Like the reference's
    ``restore``, the device mirror is rebuilt from the host truth at the
    next dispatch."""
    missing = [k for k in SNAPSHOT_KEYS if k not in snap]
    if missing:
        raise KeyError(f"snapshot lacks {missing}")
    base = graph_from_numpy(base_arrays["cap"], base_arrays["bw"],
                            base_arrays["lat"])
    n = base.n
    if np.shape(snap["cap"]) != (n,) or np.shape(snap["bw"]) != (n, n):
        raise ValueError("snapshot does not match the base network's size")
    res = ResidualState(base, device=resolve_device(device))
    res.restore({
        "cap": np.asarray(snap["cap"], np.float64),
        "bw": np.asarray(snap["bw"], np.float64),
        "node_up": np.asarray(snap["node_up"], bool),
        "link_up": np.asarray(snap["link_up"], bool),
    })
    return res
