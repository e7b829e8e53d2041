"""Region-local compacted solve substrate: global <-> local id bijections.

Port of ``repro/core/compact.py`` (numpy only).

The decentralized control plane shards the network into R regions, but a
region that keeps *global* node ids (masking foreign capacity to zero)
still pays the global ``n`` in every solve: the DP state is (n, p+1), the
batched kernel pads its tiles to n, and the residual bookkeeping is
O(n^2) per region.  Sharding then buys message locality but zero compute
locality — R regions are not R x smaller solves.

A :class:`CompactedView` is the bijection that fixes this: region ``r``
owns ``n_r`` global nodes; the view maps them onto the contiguous local
id space ``[0, n_r)`` and carries

- the **remapped network tensors** (``cap``/``bw``/``lat`` sliced to the
  member rows/columns — cross-region links drop out of the submatrix by
  construction), exposed as an ``n_r``-node :class:`ResourceGraph`;
- **read-through** for residual state: :meth:`compact_graph` slices any
  global-shaped graph (e.g. a residual snapshot) down to the local space,
  so a solver only ever sees ``n_r``;
- **write-through** for committed state: :meth:`uncompact_node_load` /
  :meth:`uncompact_edge_load` / the ``uncompact_*_vec`` scatter helpers
  lift local ticket loads and residual arrays back to global ids, so a
  global conservation ledger stays checkable over locally-sized regions;
- a **version** counter, bumped by :meth:`invalidate` whenever the
  region's slice of truth changes (node/link churn).  Holders that record
  local ids next to the version (the 2PC broker's spanning parts) can
  detect handles minted under a stale bijection generation.

The identity view (:meth:`CompactedView.identity`, or any view covering
every node in order) short-circuits every translation to return its input
*object* unchanged — the R = 1 regional plane therefore stays bit-for-bit
identical to the centralized plane, by construction rather than by
re-verification.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import DataflowPath, Mapping, ResourceGraph


@dataclasses.dataclass(eq=False)
class CompactedView:
    """Global <-> local node-id bijection for one region.

    ``nodes`` holds the member global ids in ascending order; local id
    ``i`` denotes global node ``nodes[i]``.  All translation methods
    raise ``ValueError`` for ids outside the member set — a foreign id
    reaching a region's solve path is a broker bug, never a mask.
    """

    base: ResourceGraph  # the full global graph this view slices
    nodes: np.ndarray  # (n_local,) ascending global ids
    version: int = 0

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, np.int64)
        if self.nodes.size == 0:
            raise ValueError(
                "CompactedView over an empty region: every region must own "
                "at least one node (check partition_regions / region_of)"
            )
        if np.any(np.diff(self.nodes) <= 0):
            raise ValueError("view nodes must be strictly ascending")
        if self.nodes[0] < 0 or self.nodes[-1] >= self.base.n:
            raise ValueError("view nodes out of range for the base graph")
        self._local_of = np.full(self.base.n, -1, np.int64)
        self._local_of[self.nodes] = np.arange(self.n_local)
        self.is_identity = bool(
            self.n_local == self.base.n
            and np.array_equal(self.nodes, np.arange(self.base.n))
        )
        self._graph = None  # cached compacted base tensors
        # derivation links (hierarchical planes): views nested over this
        # view's compacted graph, and the view this one was derived from.
        # Invalidation propagates through the chain — see invalidate().
        self._outer: "CompactedView | None" = None
        self._inner: list["CompactedView"] = []

    # -- construction --------------------------------------------------------

    @staticmethod
    def identity(rg: ResourceGraph) -> "CompactedView":
        """The whole-graph view: every translation is the identity (and
        returns its input object unchanged — the R=1 bit-identity hook)."""
        return CompactedView(rg, np.arange(rg.n, dtype=np.int64))

    @staticmethod
    def from_assign(
        rg: ResourceGraph, assign: np.ndarray, r: int
    ) -> "CompactedView":
        """The view of region ``r`` under a node -> region assignment."""
        members = np.nonzero(np.asarray(assign) == r)[0]
        if members.size == 0:
            raise ValueError(
                f"region {r} is empty under the given assignment "
                f"(n={rg.n}); partition the graph into fewer regions or "
                "merge the empty region before building views"
            )
        return CompactedView(rg, members)

    # -- sizes ---------------------------------------------------------------

    @property
    def n_local(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def n_global(self) -> int:
        return self.base.n

    # -- id translation ------------------------------------------------------

    def contains(self, v: int) -> bool:
        return 0 <= int(v) < self.base.n and self._local_of[int(v)] >= 0

    def to_local(self, v):
        """Global -> local ids (scalar or array); raises on foreign ids."""
        lv = self._local_of[np.asarray(v)]
        if np.any(np.asarray(lv) < 0):
            raise ValueError(f"node(s) {v!r} not in this view's region")
        return lv if isinstance(lv, np.ndarray) else int(lv)

    def to_global(self, v):
        """Local -> global ids (scalar or array)."""
        gv = self.nodes[np.asarray(v)]
        return gv if isinstance(gv, np.ndarray) else int(gv)

    # -- graph compaction (residual read-through) ----------------------------

    def graph(self) -> ResourceGraph:
        """The compacted base network (cached; rebuilt by invalidate)."""
        if self._graph is None:
            self._graph = self.compact_graph(self.base)
        return self._graph

    def compact_graph(self, rg: ResourceGraph) -> ResourceGraph:
        """Slice any global-shaped graph (base or a residual snapshot) to
        the local id space.  Cross-region links are outside the submatrix,
        so nothing foreign survives — no masking, no sentinel rows."""
        if self.is_identity:
            return rg
        assert rg.n == self.base.n, "compact_graph expects a global graph"
        ix = np.ix_(self.nodes, self.nodes)
        return ResourceGraph(rg.cap[self.nodes], rg.bw[ix], rg.lat[ix])

    # -- request / mapping translation ---------------------------------------

    def compact_df(self, df: DataflowPath) -> DataflowPath:
        """Re-pin a dataflow's endpoints into local ids (requirements are
        id-free and shared by reference)."""
        if self.is_identity:
            return df
        return DataflowPath(
            df.creq, df.breq, self.to_local(df.src), self.to_local(df.dst)
        )

    def uncompact_df(self, df: DataflowPath) -> DataflowPath:
        if self.is_identity:
            return df
        return DataflowPath(
            df.creq, df.breq, self.to_global(df.src), self.to_global(df.dst)
        )

    def compact_mapping(self, m: Mapping) -> Mapping:
        if self.is_identity:
            return m
        return Mapping(
            tuple(int(x) for x in self.to_local(np.asarray(m.assign))),
            tuple(int(x) for x in self.to_local(np.asarray(m.route))),
            m.cost,
        )

    def uncompact_mapping(self, m: Mapping) -> Mapping:
        """Lift a local-id mapping back to global ids (cost unchanged —
        the compacted tensors are slices, not rescalings)."""
        if self.is_identity:
            return m
        return Mapping(
            tuple(int(x) for x in self.to_global(np.asarray(m.assign))),
            tuple(int(x) for x in self.to_global(np.asarray(m.route))),
            m.cost,
        )

    # -- load / residual translation (write-through) -------------------------

    def uncompact_node_load(self, load: dict) -> dict:
        """Local ticket node-load -> global ids."""
        if self.is_identity:
            return dict(load)
        return {self.to_global(v): c for v, c in load.items()}

    def uncompact_edge_load(self, load: dict) -> dict:
        """Local ticket edge-load -> global id pairs."""
        if self.is_identity:
            return dict(load)
        return {
            (self.to_global(u), self.to_global(v)): b
            for (u, v), b in load.items()
        }

    def uncompact_node_vec(self, vec: np.ndarray) -> np.ndarray:
        """Scatter a local per-node vector (e.g. residual capacity) into a
        global-sized vector, zero outside the region."""
        out = np.zeros(self.base.n, dtype=np.asarray(vec).dtype)
        out[self.nodes] = vec
        return out

    def uncompact_link_mat(self, mat: np.ndarray) -> np.ndarray:
        """Scatter a local link matrix (e.g. residual bandwidth) into a
        global-sized matrix, zero outside the region's submatrix."""
        out = np.zeros((self.base.n, self.base.n), dtype=np.asarray(mat).dtype)
        out[np.ix_(self.nodes, self.nodes)] = mat
        return out

    # -- nesting (hierarchical planes) ---------------------------------------

    def derive(self, nodes: np.ndarray) -> "CompactedView":
        """A nested view over THIS view's compacted graph: ``nodes`` are
        ascending ids in this view's *local* space.  The child is linked
        into the derivation chain so :meth:`invalidate` propagates (see
        there for the direction rules)."""
        return self.adopt(CompactedView(self.graph(), np.asarray(nodes, np.int64)))

    def adopt(self, child: "CompactedView") -> "CompactedView":
        """Link an existing view built over this view's compacted graph
        into the derivation chain (used when a child plane constructs its
        own views over ``outer.graph()``)."""
        if child.base.n != self.n_local:
            raise ValueError(
                f"cannot adopt: child view is over an n={child.base.n} graph "
                f"but this view compacts to n_local={self.n_local}"
            )
        child._outer = self
        self._inner.append(child)
        return child

    def compose(self, inner: "CompactedView") -> "CompactedView":
        """Flatten a bijection-of-bijection into one direct view: ``inner``
        maps ids of this view's compacted graph; the result maps
        ``inner``-local ids straight to THIS view's base (global) ids.

        The composed view is a snapshot (its version is the sum of the two
        generations at compose time) and is not linked into the derivation
        chain — use it for cross-level lifts (write-through conservation),
        not as a long-lived handle."""
        if inner.base.n != self.n_local:
            raise ValueError(
                f"cannot compose: inner view is over an n={inner.base.n} "
                f"graph but this view compacts to n_local={self.n_local}"
            )
        return CompactedView(
            self.base, self.nodes[inner.nodes], version=self.version + inner.version
        )

    # -- invalidation --------------------------------------------------------

    def invalidate(self) -> int:
        """The region's slice of truth changed (node/link churn): bump the
        bijection generation and drop the cached compacted tensors.  Ids
        themselves are stable under liveness churn — the version exists so
        holders of (local id, version) records can tell which generation
        minted them.

        Propagation through a derivation chain: *ancestors* contain this
        region's slice, so their generation bumps too (a leaf churn is
        visible at every enclosing level); *descendants* slice this view's
        tensors, so they bump when THIS view is the invalidation origin.
        Siblings are untouched — their slice of truth did not change."""
        self._bump_up()
        self._bump_down()
        return self.version

    def _bump_up(self) -> None:
        self.version += 1
        self._graph = None
        if self._outer is not None:
            self._outer._bump_up()

    def _bump_down(self) -> None:
        for child in self._inner:
            child.version += 1
            child._graph = None
            child._bump_down()


def compact_view(rg: ResourceGraph, assign: np.ndarray, r: int) -> CompactedView:
    """Functional alias for :meth:`CompactedView.from_assign`."""
    return CompactedView.from_assign(rg, assign, r)
