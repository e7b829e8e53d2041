"""Random resource-network topologies and dataflow paths.

Numpy copy of ``repro/core/topology.py`` (same seeds, same instances).

The paper evaluates on BRITE-generated Internet topologies [7].  BRITE's two
router-level models are Waxman and Barabasi-Albert; we implement both with
the same parameterization (nodes in a unit square, distance-proportional
latency) plus uniform capacity/bandwidth annotations, and a generator for
random dataflow paths, so the benchmark instances match the paper's setup.
"""
from __future__ import annotations

import numpy as np

from .graph import INF, DataflowPath, ResourceGraph


def _annotate(
    rng: np.random.Generator,
    pos: np.ndarray,
    adj: np.ndarray,
    cap_range=(2.0, 10.0),
    bw_range=(10.0, 100.0),
    lat_scale=10.0,
) -> ResourceGraph:
    n = pos.shape[0]
    # Connect components (BRITE guarantees connectivity): link each component
    # representative to the nearest node outside it.
    comp = np.arange(n)

    def find(a):
        while comp[a] != a:
            comp[a] = comp[comp[a]]
            a = comp[a]
        return a

    for u, v in zip(*np.nonzero(adj)):
        comp[find(u)] = find(v)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    while True:
        roots = {find(i) for i in range(n)}
        if len(roots) == 1:
            break
        r = min(roots)
        mine = np.array([find(i) == find(r) for i in range(n)])
        dd = np.where(mine[:, None] & ~mine[None, :], d2, np.inf)
        u, v = np.unravel_index(np.argmin(dd), dd.shape)
        adj[u, v] = adj[v, u] = True
        comp[find(u)] = find(v)

    dist = np.sqrt(d2)
    cap = rng.uniform(*cap_range, size=n).astype(np.float32)
    bw = np.zeros((n, n), np.float32)
    lat = np.full((n, n), INF, np.float32)
    np.fill_diagonal(lat, 0.0)
    bvals = rng.uniform(*bw_range, size=(n, n)).astype(np.float32)
    bvals = np.minimum(bvals, bvals.T)  # symmetric links
    m = adj | adj.T
    bw[m] = bvals[m]
    lat[m] = (lat_scale * dist[m] + 0.1).astype(np.float32)  # strictly > 0
    return ResourceGraph(cap, bw, lat)


def waxman(
    n: int,
    *,
    alpha: float = 0.4,
    beta: float = 0.3,
    seed: int = 0,
    **annotate_kw,
) -> ResourceGraph:
    """Waxman model: P(u,v) = alpha * exp(-d(u,v) / (beta * L))."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(size=(n, 2))
    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    L = np.sqrt(2.0)
    prob = alpha * np.exp(-d / (beta * L))
    adj = (rng.uniform(size=(n, n)) < prob) & ~np.eye(n, dtype=bool)
    adj = np.triu(adj, 1)
    return _annotate(rng, pos, adj, **annotate_kw)


def barabasi_albert(n: int, *, m: int = 2, seed: int = 0, **annotate_kw) -> ResourceGraph:
    """BA preferential attachment (BRITE's second router model)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(size=(n, 2))
    adj = np.zeros((n, n), dtype=bool)
    deg = np.zeros(n)
    start = min(m + 1, n)
    for u in range(start):
        for v in range(u + 1, start):
            adj[u, v] = True
            deg[u] += 1
            deg[v] += 1
    for u in range(start, n):
        p = deg[:u] / deg[:u].sum()
        targets = rng.choice(u, size=min(m, u), replace=False, p=p)
        for v in targets:
            adj[min(u, v), max(u, v)] = True
            deg[u] += 1
            deg[v] += 1
    return _annotate(rng, pos, adj, **annotate_kw)


def region_line(
    R: int,
    k: int = 4,
    *,
    cap_range=(2.0, 10.0),
    bw_range=(10.0, 100.0),
    lat_intra: float = 1.0,
    lat_inter: float = 5.0,
    gateways: int = 1,
    seed: int = 0,
) -> tuple[ResourceGraph, np.ndarray]:
    """A line of ``R`` fully-connected ``k``-node regions.

    Consecutive regions are joined by ``gateways`` inter-region links
    (node ``k-1-g`` of region ``r`` to node ``g`` of region ``r+1``), so a
    dataflow pinned from region 0 to region ``R-1`` can only be served by
    a spanning chain through every region in between — the multi-hop
    decomposition scenario of the regional control plane.  Returns
    ``(graph, assign)`` where ``assign`` is the canonical node -> region
    map (pass it as ``RegionalControlPlane(region_of=assign)`` to pin the
    partition to the topology).
    """
    assert R >= 1 and k >= 1 and 1 <= gateways <= k
    rng = np.random.default_rng(seed)
    n = R * k
    cap = rng.uniform(*cap_range, size=n).astype(np.float32)
    bw = np.zeros((n, n), np.float32)
    lat = np.full((n, n), INF, np.float32)
    np.fill_diagonal(lat, 0.0)

    def _link(u, v, l):
        b = float(rng.uniform(*bw_range))
        bw[u, v] = bw[v, u] = b
        lat[u, v] = lat[v, u] = l

    for r in range(R):
        base = r * k
        for i in range(k):
            for j in range(i + 1, k):
                _link(base + i, base + j, lat_intra)
        if r + 1 < R:
            for g in range(gateways):
                _link(base + (k - 1 - g), base + k + g, lat_inter)
    assign = np.repeat(np.arange(R, dtype=np.int64), k)
    return ResourceGraph(cap, bw, lat), assign


def region_grid(
    rows: int,
    cols: int,
    k: int = 4,
    *,
    cap_range=(2.0, 10.0),
    bw_range=(10.0, 100.0),
    lat_intra: float = 1.0,
    lat_inter: float = 5.0,
    seed: int = 0,
) -> tuple[ResourceGraph, np.ndarray]:
    """A ``rows x cols`` grid of fully-connected ``k``-node regions.

    Regions are numbered row-major (region ``i * cols + j`` sits at grid
    cell ``(i, j)``); horizontally and vertically adjacent regions are
    joined by one inter-region link each.  Unlike :func:`region_line`,
    whose quotient graph is a single path, the grid's quotient graph has
    *distinct* region chains between most pairs — the topology k-shortest
    multi-chain routing needs: when the fewest-hop chain runs through a
    saturated region, a longer bypass chain exists around it.

    Gateway node indices rotate per direction (east uses node ``k-1`` ->
    ``0``, south uses ``k-2`` -> ``1``, mod ``k``) so a region's cuts do
    not all share one node where ``k`` allows.  Returns ``(graph,
    assign)`` with ``assign`` the canonical node -> region map.
    """
    assert rows >= 1 and cols >= 1 and k >= 1
    rng = np.random.default_rng(seed)
    R = rows * cols
    n = R * k
    cap = rng.uniform(*cap_range, size=n).astype(np.float32)
    bw = np.zeros((n, n), np.float32)
    lat = np.full((n, n), INF, np.float32)
    np.fill_diagonal(lat, 0.0)

    def _link(u, v, l):
        b = float(rng.uniform(*bw_range))
        bw[u, v] = bw[v, u] = b
        lat[u, v] = lat[v, u] = l

    for r in range(R):
        base = r * k
        for i in range(k):
            for j in range(i + 1, k):
                _link(base + i, base + j, lat_intra)
    for i in range(rows):
        for j in range(cols):
            base = (i * cols + j) * k
            if j + 1 < cols:  # east
                _link(base + (k - 1), (i * cols + j + 1) * k, lat_inter)
            if i + 1 < rows:  # south
                _link(base + (k - 2) % k,
                      ((i + 1) * cols + j) * k + (1 % k), lat_inter)
    assign = np.repeat(np.arange(R, dtype=np.int64), k)
    return ResourceGraph(cap, bw, lat), assign


def region_tree(
    levels: int,
    branching: int,
    k: int = 4,
    *,
    cap_range=(2.0, 10.0),
    bw_range=(10.0, 100.0),
    lat_intra: float = 1.0,
    lat_level: float = 5.0,
    gateway_bw_scale: float = 4.0,
    seed: int = 0,
) -> tuple[ResourceGraph, np.ndarray]:
    """A ``branching``-ary tree of fully-meshed ``k``-node leaf regions.

    ``branching ** levels`` leaf regions are numbered depth-first, so any
    contiguous block of ``branching ** (levels - 1)`` leaves is exactly one
    top-level subtree — the grouping the hierarchical control plane uses.
    At every tree level ``l`` in ``1..levels`` the ``branching`` sibling
    subtrees under a common parent are joined all-to-all by one gateway
    link per pair (between the first leaf of each subtree, on node index
    ``(l - 1) % k`` so distinct levels use distinct gateway nodes where
    ``k`` allows), with latency ``lat_level * l`` — higher cuts are more
    expensive, as in a datacenter/pod/rack hierarchy.  Gateway links get
    ``gateway_bw_scale`` x the leaf bandwidth draw since they carry
    aggregated traffic.

    Returns ``(graph, assign)`` where ``assign`` maps node -> leaf region;
    pass it as ``ControlPlane(region_of=assign, levels=...)``.
    """
    assert levels >= 1 and branching >= 1 and k >= 1
    rng = np.random.default_rng(seed)
    leaves = branching**levels
    n = leaves * k
    cap = rng.uniform(*cap_range, size=n).astype(np.float32)
    bw = np.zeros((n, n), np.float32)
    lat = np.full((n, n), INF, np.float32)
    np.fill_diagonal(lat, 0.0)

    def _link(u, v, l, scale=1.0):
        b = scale * float(rng.uniform(*bw_range))
        bw[u, v] = bw[v, u] = b
        lat[u, v] = lat[v, u] = l

    for leaf in range(leaves):
        base = leaf * k
        for i in range(k):
            for j in range(i + 1, k):
                _link(base + i, base + j, lat_intra)
    for lvl in range(1, levels + 1):
        sub = branching ** (lvl - 1)  # leaves per child subtree at this level
        block = sub * branching  # leaves per parent block
        gw = (lvl - 1) % k
        for start in range(0, leaves, block):
            reps = [(start + c * sub) * k + gw for c in range(branching)]
            for i in range(branching):
                for j in range(i + 1, branching):
                    _link(reps[i], reps[j], lat_level * lvl, gateway_bw_scale)
    assign = np.repeat(np.arange(leaves, dtype=np.int64), k)
    return ResourceGraph(cap, bw, lat), assign


def random_dataflow(
    rg: ResourceGraph,
    p: int,
    *,
    seed: int = 0,
    creq_range=(0.5, 3.0),
    breq_range=(10.0, 60.0),
    endpoint_creq: float = 0.0,
) -> DataflowPath:
    """Random linear dataflow computation with pinned random endpoints."""
    rng = np.random.default_rng(seed)
    creq = rng.uniform(*creq_range, size=p).astype(np.float32)
    creq[0] = creq[-1] = endpoint_creq
    breq = rng.uniform(*breq_range, size=p - 1).astype(np.float32)
    src, dst = rng.choice(rg.n, size=2, replace=False)
    return DataflowPath(creq, breq, int(src), int(dst))


def paper_example() -> tuple[ResourceGraph, DataflowPath]:
    """The worked example of paper Fig. 1 + Fig. 3 (path topology).

    Eight nodes A..H.  Figure annotations are partially illegible in the
    text, so values are chosen consistent with the described feasible/optimal
    mapping (s->B, x1,x2->B, x3->D, t->F): B has enough capacity for three
    computations, D for one, and the B-D-F corridor is the low-latency route.
    """
    A, B, C, D, E, F, G, H = range(8)
    cap = [2.0, 6.0, 2.0, 3.0, 4.0, 1.0, 3.0, 2.0]
    edges = [
        (A, B, 40.0, 3.0), (A, C, 60.0, 2.0), (B, D, 50.0, 2.0),
        (C, E, 50.0, 2.0), (C, G, 40.0, 4.0), (D, E, 40.0, 3.0),
        (D, F, 60.0, 2.0), (E, G, 50.0, 2.0), (F, G, 30.0, 3.0),
        (F, H, 40.0, 2.0), (G, H, 50.0, 2.0),
    ]
    rg = ResourceGraph.from_edge_list(cap, edges)
    df = DataflowPath.make(
        creq=[0.0, 2.0, 2.0, 1.5, 0.0], breq=[30.0, 25.0, 25.0, 20.0], src=B, dst=F
    )
    return rg, df
