"""The port's centralized control plane (``repro_torch.service.ControlPlane``)
against the reference, step by step: one seeded fuzz of weighted tenants in
all three preemption classes, preemption and ``admit_preempting``, defrag,
node and link churn, at pipeline depths 1 and 2.  Rids, tickets, the
conservation ledger, ``fairness_summary`` and every ``OnlineStats`` counter
agree bit for bit after every step (wall clock excluded)."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
import repro_torch.service as TS

from torch_parity import port_df
from torch_planes import (PORT_CFG, REF_CFG, Lockstep, canon, make_pair,
                         online_counters)

TENANTS = {"a": dict(weight=3.0), "b": dict(weight=1.0),
           "c": dict(weight=2.0, budget=1.5)}


def _fuzz(seed, depth, steps=60):
    rng = np.random.default_rng(seed)
    # a tenth of the Waxman capacities, so that admissions compete for
    # compute and high classes preempt
    w = R.waxman(12, seed=4)
    rg = R.ResourceGraph(w.cap * 0.1, w.bw, w.lat)
    a, b = make_pair(rg, policy=dict(slack=0.4), micro_batch=6,
                     max_attempts=3, pipeline_depth=depth)
    ls = Lockstep(a, b)
    for name, kw in TENANTS.items():
        ls.register_tenant(name, **kw)
    edges = list(rg.edges())
    failed_nodes, failed_links = [], []
    ops = {"submit": 0.40, "pump": 0.22, "release": 0.06, "fail_node": 0.06,
           "restore_node": 0.06, "fail_link": 0.05, "restore_link": 0.05,
           "defrag": 0.10}
    for step in range(steps):
        op = rng.choice(list(ops), p=list(ops.values()))
        if op == "submit":
            df = R.random_dataflow(rg, 4, seed=1000 * seed + step,
                                   creq_range=(0.05, 0.3),
                                   breq_range=(0.5, 3.0))
            ls.submit(str(rng.choice(list(TENANTS))), df,
                      klass=int(rng.integers(0, 3)))
        elif op == "pump":
            ls.pump(rounds=int(rng.integers(1, 3)))
        elif op == "release" and a.active:
            ls.release(int(rng.choice(sorted(a.active))))
        elif op == "fail_node" and len(failed_nodes) < 3:
            v = int(rng.integers(0, rg.n))
            if v not in failed_nodes:
                ls.fail_node(v)
                failed_nodes.append(v)
        elif op == "restore_node" and failed_nodes:
            ls.restore_node(failed_nodes.pop(
                int(rng.integers(0, len(failed_nodes)))))
        elif op == "fail_link" and len(failed_links) < 2:
            u, v = edges[int(rng.integers(0, len(edges)))]
            ls.fail_link(u, v)
            failed_links.append((u, v))
        elif op == "restore_link" and failed_links:
            ls.restore_link(*failed_links.pop(
                int(rng.integers(0, len(failed_links)))))
        elif op == "defrag":
            ls.defrag()
        ls.check()
    ls.flush()
    ls.check()
    return a, b


@pytest.mark.parametrize(("seed", "depth", "preempts"),
                         [(7, 1, True), (8, 1, True), (8, 2, True),
                          (5, 2, False)])
def test_centralized_plane_matches_reference_step_by_step(seed, depth,
                                                          preempts):
    a, b = _fuzz(seed, depth)
    led = b.conservation()
    assert led["ok"] and led["in_flight"] == 0 and led["submitted"] > 0
    st = b.placer.stats
    # the script reached the paths this test is about
    assert st.solves and st.defrag_commits and st.warm_solves
    assert bool(st.preempted) == preempts
    assert depth == 1 or st.stale_batches
    assert set(st.kernel_impls) == {"plain"}


def _filled(module, rg, cfg):
    """A placer whose three tickets fill node 1 of a 0-1-2 line."""
    placer = module.OnlinePlacer(rg, **cfg)
    for k in range(3):
        df = module.DataflowPath.make([0.0, 1.0, 0.0], [1.0, 1.0], 0, 2)
        assert placer.admit(df, tenant="low", klass=0) is not None
    return placer


def _line(module):
    cap = np.array([0.0, 3.5, 0.0], np.float32)
    bw = np.zeros((3, 3), np.float32)
    lat = np.full((3, 3), np.inf, np.float32)
    for u, v in ((0, 1), (1, 2)):
        bw[u, v] = bw[v, u] = 50.0
        lat[u, v] = lat[v, u] = 1.0
    return module.ResourceGraph(cap, bw, lat)


@pytest.mark.parametrize("budget", [None, 2.0, 1.0, 0.0])
def test_admit_preempting_matches_reference(budget):
    """Victim order, the cost budget, the rollback and the solve accounting
    it keeps across the rollback are the reference's."""
    ra = _filled(R, _line(R), REF_CFG)
    pb = _filled(T, _line(T), PORT_CFG)
    for klass, creq in ((1, 1.5), (2, 2.5), (1, 9.0)):
        df = R.DataflowPath.make([0.0, creq, 0.0], [1.0, 1.0], 0, 2)
        ta, va = ra.admit_preempting(df, tenant="hi", klass=klass,
                                     max_displaced_cost=budget)
        tb, vb = pb.admit_preempting(port_df(df), tenant="hi", klass=klass,
                                     max_displaced_cost=budget)
        assert canon(ta) == canon(tb) and canon(va) == canon(vb)
        assert online_counters(ra.stats) == online_counters(pb.stats)
        np.testing.assert_array_equal(ra.cap, pb.cap)
        pb.check_invariants()
    assert pb.stats.solves > 0
    assert bool(pb.stats.preempted) == (budget != 0.0)


def test_cache_suspended_bypasses_lookups_and_fills():
    rg = T.waxman(10, seed=2)
    placer = T.OnlinePlacer(rg, device="cpu")
    df = T.random_dataflow(rg, 4, seed=3, creq_range=(0.05, 0.1),
                           breq_range=(0.5, 1.0))
    with placer.cache_suspended():
        t = placer.admit(df)
        assert t is not None and len(placer.cache) == 0
        placer.release(t)
        assert placer.admit(df) is not None
    assert placer.stats.cache_hits == 0 and placer.stats.cache_misses == 0
    placer.admit(df)  # outside the block the cache is back
    assert placer.stats.cache_misses == 1


def test_solve_accounting_survives_restore():
    rg = T.waxman(10, seed=2)
    placer = T.OnlinePlacer(rg, device="cpu")
    snap = placer.snapshot()
    placer.admit(T.random_dataflow(rg, 4, seed=5))
    acct = placer.stats.solve_accounting()
    placer.restore(snap)
    assert placer.stats.solves == 0
    placer.stats.restore_solve_accounting(acct)
    assert placer.stats.solves == 1 and placer.stats.admitted == 0


def test_plane_device_defaults_to_cuda_and_reaches_the_placer(monkeypatch):
    import torch

    rg = T.waxman(8, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.ControlPlane(rg)
    cp = TS.ControlPlane(rg, device="cpu", kernel_impl="plain")
    assert cp.placer.device.type == "cpu"
    assert cp.placer.solve_cfg["kernel_impl"] == "plain"
    assert cp.placer.method == "leastcost_torch"
