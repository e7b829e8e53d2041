"""Lockstep drivers for the parity tests of the port's control planes.

The reference plane (``repro.service``, ``method="leastcost_jax",
use_kernel=True, kernel_impl="ref"``) and the port's (``repro_torch.service``,
``device="cpu"``) get the same seeded operations; ``Lockstep`` applies each
one to both and compares what they return, and ``assert_same_planes``
compares their whole observable state: tickets, residual arrays, ledgers,
reports, ``OnlineStats`` counters and the metrics snapshot.  Wall-clock
fields (``timing.*``, ``solve_ms``, ``overhead_ms``,
``conflict_resolve_ms``) are left out; the solver's labels are mapped onto
one name (``ref`` and ``plain`` are the two packages' names for the plain
superstep, ``leastcost_jax`` and ``leastcost_torch`` for the method)."""
import dataclasses
from types import MappingProxyType

import numpy as np

import repro.core as R
import repro.service as RS
import repro_torch.service as TS

from torch_parity import port_df, port_graph

REF_CFG = dict(method="leastcost_jax", use_kernel=True, kernel_impl="ref")
PORT_CFG = dict(device="cpu")
WALL_CLOCK = ("solve_ms", "overhead_ms", "conflict_resolve_ms")
_LABELS = {"ref": "plain", "leastcost_jax": "leastcost_torch"}


def _label(s: str) -> str:
    for a, b in _LABELS.items():
        s = s.replace(f"={a}", f"={b}")
    return _LABELS.get(s, s)


def canon(x):
    """A package-independent, comparable form of anything a plane returns:
    dataclasses by class name and fields, arrays as lists, floats exact."""
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (dict, MappingProxyType)):
        return sorted((canon(k), canon(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                [(f.name, canon(getattr(x, f.name)))
                 for f in dataclasses.fields(x)])
    raise TypeError(f"no canonical form for {type(x).__name__}")


def placers(cp) -> list:
    """Every OnlinePlacer under a plane, in plane order."""
    if hasattr(cp, "placer"):
        return [cp.placer]
    subs = cp.children if hasattr(cp, "children") else cp.regions
    return [p for sub in subs for p in placers(sub)]


def online_counters(st) -> dict:
    d = dataclasses.asdict(st)
    for k in WALL_CLOCK:
        d.pop(k)
    d["kernel_impls"] = {_label(k): v for k, v in d["kernel_impls"].items()}
    return d


def _no_timing(rep):
    if isinstance(rep, dict):
        return {k: _no_timing(v) for k, v in rep.items() if k != "timing"}
    return rep


def registry_snapshot(cp) -> dict:
    return {_label(k): v for k, v in cp.metrics_registry().snapshot().items()
            if not k.startswith("timing.")}


def engine_counters(cp) -> dict:
    d = dataclasses.asdict(cp.engine_stats())
    for k in WALL_CLOCK:
        d.pop(k)
    d["kernel_impl"] = _label(d["kernel_impl"])
    d["method"] = _label(d["method"])
    return d


def plane_state(cp) -> dict:
    """Everything a caller can observe of a plane, wall clock excluded."""
    out = {
        "conservation": canon(cp.conservation()),
        "active_ids": canon(cp.active_ids()),
        "fairness": canon(_no_timing(cp.fairness_report())),
        "engine": engine_counters(cp),
        "registry": registry_snapshot(cp),
    }
    for name in ("span_stats", "cut_residual", "node_up"):
        if hasattr(cp, name):
            out[name] = canon(getattr(cp, name))
    if hasattr(cp, "coordination_report"):
        out["coordination"] = canon(cp.coordination_report())
    out["placers"] = [
        (canon(p.tickets), canon(p.cap), canon(p.bw), canon(p.node_up),
         canon(p.link_up), p.epoch, online_counters(p.stats))
        for p in placers(cp)
    ]
    return out


def assert_same_planes(a, b) -> None:
    sa, sb = plane_state(a), plane_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k] == sb[k], f"planes differ in {k}"


def make_pair(rg, policy=None, **kw):
    """The reference plane on ``rg`` and the port's on a copy of it, built
    by the same facade with the same keyword arguments.  ``policy`` is a
    dict of ``FairSharePolicy`` arguments (each package has its own)."""
    kw_ref, kw_port = dict(kw), dict(kw)
    if policy is not None:
        kw_ref["policy"] = RS.FairSharePolicy(**policy)
        kw_port["policy"] = TS.FairSharePolicy(**policy)
    a = RS.ControlPlane(rg, **REF_CFG, **kw_ref)
    b = TS.ControlPlane(port_graph(rg), **PORT_CFG, **kw_port)
    return a, b


def assert_same_placers(a, b) -> None:
    """The identity checks between two planes of the port: the same
    ledger, active set and placer states (tickets, residuals, counters)."""
    assert canon(a.conservation()) == canon(b.conservation())
    assert a.active_ids() == b.active_ids()
    sa = [(canon(p.tickets), canon(p.cap), canon(p.bw), canon(p.node_up),
           canon(p.link_up), online_counters(p.stats)) for p in placers(a)]
    sb = [(canon(p.tickets), canon(p.cap), canon(p.bw), canon(p.node_up),
           canon(p.link_up), online_counters(p.stats)) for p in placers(b)]
    assert sa == sb


class Lockstep:
    """Apply each plane operation to two planes (by default the reference
    and the port), and hold what they return equal.  ``full=False`` checks
    only what :func:`assert_same_placers` compares, for two planes of
    different kinds."""

    def __init__(self, a, b, *, to_b=port_df, full=True):
        self.a, self.b = a, b
        self.to_b = to_b
        self.full = full

    def register_tenant(self, name, **kw):
        self.a.register_tenant(name, **kw)
        self.b.register_tenant(name, **kw)

    def submit(self, tenant, df, klass=0) -> int:
        ra = self.a.submit(tenant, df, klass=klass)
        rb = self.b.submit(tenant, self.to_b(df), klass=klass)
        assert ra == rb
        return ra

    def _same(self, name, *args, **kw):
        ra = getattr(self.a, name)(*args, **kw)
        rb = getattr(self.b, name)(*args, **kw)
        assert canon(ra) == canon(rb), f"{name}{args} returned different results"
        return ra

    def pump(self, rounds=1):
        return self._same("pump", rounds=rounds)

    def flush(self):
        return self._same("flush")

    def release(self, rid):
        return self._same("release", rid)

    def fail_node(self, v):
        return self._same("fail_node", v)

    def restore_node(self, v):
        return self._same("restore_node", v)

    def fail_link(self, u, v):
        return self._same("fail_link", u, v)

    def restore_link(self, u, v):
        return self._same("restore_link", u, v)

    def defrag(self):
        ra, rb = self.a.defrag(), self.b.defrag()
        if not isinstance(ra, list):  # the centralized plane's one result
            ra = [ra]
        if not isinstance(rb, list):
            rb = [rb]
        assert canon(ra) == canon(rb), "defrag returned different results"
        return ra

    def check(self) -> None:
        self.a.check_invariants()
        self.b.check_invariants()
        if self.full:
            assert_same_planes(self.a, self.b)
        else:
            assert_same_placers(self.a, self.b)


OPS = {"submit": 0.30, "pump": 0.25, "release": 0.13, "fail_node": 0.08,
       "restore_node": 0.08, "partition": 0.05, "heal": 0.05, "defrag": 0.06}


def fuzz(ls: Lockstep, rg, seed, *, steps=60, df_gen=None, cuts=(),
         tenants=("a", "b", "c")) -> None:
    """The reference's regional fuzz, in lockstep: every public operation
    interleaved (``partition`` / ``heal`` fail and restore cut links),
    every step checked."""
    rng = np.random.default_rng(seed)
    failed_nodes, failed_cuts = [], []
    cuts = sorted(cuts)
    for step in range(steps):
        op = rng.choice(list(OPS), p=list(OPS.values()))
        if op == "submit":
            if df_gen is not None:
                df = df_gen(rng, step)
            else:
                df = R.random_dataflow(rg, 4, seed=1000 * seed + step,
                                       creq_range=(0.05, 0.3),
                                       breq_range=(0.5, 3.0))
            ls.submit(str(rng.choice(list(tenants))), df,
                      klass=int(rng.integers(0, 3)))
        elif op == "pump":
            ls.pump(rounds=int(rng.integers(1, 3)))
        elif op == "release":
            ids = ls.a.active_ids()
            if ids:
                ls.release(int(rng.choice(ids)))
        elif op == "fail_node" and len(failed_nodes) < 3:
            v = int(rng.integers(0, rg.n))
            if v not in failed_nodes:
                ls.fail_node(v)
                failed_nodes.append(v)
        elif op == "restore_node" and failed_nodes:
            ls.restore_node(failed_nodes.pop(
                int(rng.integers(0, len(failed_nodes)))))
        elif op == "partition" and cuts and len(failed_cuts) < 2:
            e = cuts[int(rng.integers(0, len(cuts)))]
            if e not in failed_cuts:
                ls.fail_link(*e)
                failed_cuts.append(e)
        elif op == "heal" and failed_cuts:
            ls.restore_link(*failed_cuts.pop(
                int(rng.integers(0, len(failed_cuts)))))
        elif op == "defrag":
            ls.defrag()
        ls.check()
    ls.flush()
    ls.check()
