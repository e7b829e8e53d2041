"""The port's compacted solve substrate (``repro_torch.core.compact``) and
its ``view=`` paths against the reference: bijection round trips (flat and
nested), region-local ``engine.solve`` / ``solve_batch`` /
``solve_batch_dispatch``, and a seeded region-local ``OnlinePlacer`` script
behind a depth-2 pipeline that bumps the view's version while a batch is
in flight.  Mappings, tickets, residuals and counters agree bit for bit."""
import numpy as np
import pytest

import repro.core as R
import repro.service as RS
import repro_torch.core as T
from repro_torch.core import engine
from repro_torch.core.problem import stack_requests

from torch_parity import port_df, port_graph, same_mapping
from torch_planes import REF_CFG, canon, online_counters


def _views(rg, R_, seed):
    assign = RS.partition_regions(rg, R_, seed=seed)
    ref = [R.compact_view(rg, assign, r) for r in range(R_)]
    port = [T.compact_view(port_graph(rg), assign, r) for r in range(R_)]
    return assign, ref, port


def _local_df(rng, members):
    s, d = rng.choice(members, size=2, replace=False)
    p = int(rng.integers(2, 5))
    return R.DataflowPath(rng.uniform(0.05, 0.4, p).astype(np.float32),
                          rng.uniform(0.5, 3.0, p - 1).astype(np.float32),
                          int(s), int(d))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bijection_round_trips_match_reference(seed):
    rng = np.random.default_rng(seed)
    rg = R.waxman(10 + 2 * seed, seed=seed)
    assign, refs, ports = _views(rg, int(rng.integers(2, 5)), seed)
    covered = np.zeros(rg.n, bool)
    for r, (vr, vp) in enumerate(zip(refs, ports)):
        members = np.nonzero(assign == r)[0]
        np.testing.assert_array_equal(vp.nodes, vr.nodes)
        loc = np.arange(vp.n_local)
        np.testing.assert_array_equal(vp.to_local(vp.to_global(loc)), loc)
        np.testing.assert_array_equal(vp.to_global(vp.to_local(members)),
                                      members)
        covered[members] = True
        foreign = np.nonzero(assign != r)[0]
        if foreign.size:
            with pytest.raises(ValueError):
                vp.to_local(int(foreign[0]))
        gr, gp = vr.graph(), vp.graph()
        for x in ("cap", "bw", "lat"):
            np.testing.assert_array_equal(getattr(gp, x), getattr(gr, x))
        df = _local_df(rng, members)
        ldf = vp.compact_df(port_df(df))
        assert (ldf.src, ldf.dst) == (vr.compact_df(df).src,
                                      vr.compact_df(df).dst)
        back = vp.uncompact_df(ldf)
        assert (back.src, back.dst) == (df.src, df.dst)
        load = {int(members[0]): 0.5}
        assert (vp.uncompact_node_load({0: 0.5}) == load
                == vr.uncompact_node_load({0: 0.5}))
        np.testing.assert_array_equal(
            vp.uncompact_link_mat(np.ones((vp.n_local, vp.n_local))),
            vr.uncompact_link_mat(np.ones((vr.n_local, vr.n_local))))
    assert covered.all()
    ident = T.CompactedView.identity(port_graph(rg))
    assert ident.is_identity and ident.compact_graph(ident.base) is ident.base


@pytest.mark.parametrize("seed", [0, 1])
def test_nested_views_compose_and_invalidate_like_reference(seed):
    rg = R.waxman(16 + 2 * seed, seed=seed)
    groups = RS.partition_regions(rg, 2, seed=seed)
    outer_r = R.compact_view(rg, groups, 0)
    outer_p = T.compact_view(port_graph(rg), groups, 0)
    inner_assign = RS.partition_regions(outer_r.graph(), 2, seed=seed + 1)
    inners = []
    for q in range(2):
        nodes = np.nonzero(inner_assign == q)[0]
        ir, ip = outer_r.derive(nodes), outer_p.derive(nodes)
        inners.append((ir, ip))
        np.testing.assert_array_equal(outer_p.compose(ip).nodes,
                                      outer_r.compose(ir).nodes)
        g1, g2 = outer_p.compose(ip).graph(), outer_r.compose(ir).graph()
        for x in ("cap", "bw", "lat"):
            np.testing.assert_array_equal(getattr(g1, x), getattr(g2, x))
    inners[0][0].invalidate()
    inners[0][1].invalidate()
    outer_r.invalidate()
    outer_p.invalidate()
    assert ([outer_p.version] + [ip.version for _, ip in inners]
            == [outer_r.version] + [ir.version for ir, _ in inners])
    with pytest.raises(ValueError, match="cannot adopt"):
        outer_p.adopt(T.CompactedView.identity(port_graph(rg)))


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_solves_through_views_match_reference(seed):
    """``solve``, ``solve_batch`` and ``solve_batch_dispatch`` with
    ``view=``: the DP runs at n_r, mappings come back in global ids."""
    rg = R.waxman(15, seed=seed)
    pg = port_graph(rg)
    assign, refs, ports = _views(rg, 3, seed)
    rng = np.random.default_rng(seed)
    for r, (vr, vp) in enumerate(zip(refs, ports)):
        members = np.nonzero(assign == r)[0]
        if members.size < 2:
            continue
        dfs = [_local_df(rng, members) for _ in range(4)]
        for df in dfs:
            mr, sr = R.solve(rg, df, view=vr, **REF_CFG)
            mp, sp = engine.solve(pg, port_df(df), view=vp, device="cpu")
            assert same_mapping(mr, mp)
            assert sp.solve_n == sr.solve_n == vp.n_local
            assert sp.rounds == sr.rounds
        msr, sr = R.solve_batch(rg, dfs, view=vr, **REF_CFG)
        pdfs = [port_df(d) for d in dfs]
        msp, sp = engine.solve_batch(pg, pdfs, view=vp, device="cpu")
        assert all(same_mapping(a, b) for a, b in zip(msr, msp))
        assert sp.solve_n == vp.n_local and sp.rounds == sr.rounds
        pending = engine.solve_batch_dispatch(pg, pdfs, view=vp, device="cpu")
        msd, sd = pending.finalize()
        assert all(same_mapping(a, b) for a, b in zip(msr, msd))
        assert sd.solve_n == vp.n_local
        with pytest.raises(AssertionError):
            engine.solve_batch(pg, pdfs, view=vp, device="cpu",
                               warm_starts=[None] * len(pdfs))
        tensors, _ = stack_requests(pg, pdfs, device="cpu", view=vp)
        assert tensors["bw"].shape == (vp.n_local, vp.n_local)
        assert int(tensors["src"][0]) == vp.to_local(dfs[0].src)


@pytest.mark.parametrize("seed", [0, 1])
def test_region_local_placer_script_matches_reference(seed):
    """A placer over one region's view, behind a depth-2 pipeline: admits,
    releases, churn and a view version bump while a batch is in flight
    (the epoch fence discards it).  Its residual tensors are n_r-sized."""
    rng = np.random.default_rng(seed)
    rg = R.waxman(20, seed=5 + seed)
    assign, refs, ports = _views(rg, 2, seed)
    vr, vp = refs[0], ports[0]
    members = np.nonzero(assign == 0)[0]
    a = R.OnlinePlacer(rg, view=vr, **REF_CFG)
    b = T.OnlinePlacer(port_graph(rg), view=vp, device="cpu")
    assert b.res.device_tensors()["bw"].shape == (vp.n_local, vp.n_local)
    pa, pb = R.AdmissionPipeline(a, 2), T.AdmissionPipeline(b, 2)
    pool = [vr.compact_df(_local_df(rng, members)) for _ in range(10)]
    bumped = 0
    for step in range(30):
        op = rng.choice(["admit", "release", "bump", "fail", "restore"],
                        p=[0.55, 0.2, 0.1, 0.075, 0.075])
        if op == "admit":
            batch = [pool[i] for i in rng.integers(0, len(pool),
                                                   int(rng.integers(1, 5)))]
            oa, ob = pa.push(batch), pb.push([port_df(d) for d in batch])
            assert canon([t for _, t in oa]) == canon([t for _, t in ob])
        elif op == "release" and a.tickets:
            tid = int(rng.choice(sorted(a.tickets)))
            a.release(tid)
            b.release(tid)
        elif op == "bump":
            vr.invalidate()
            vp.invalidate()
            bumped += 1
        elif op == "fail":
            v = int(rng.integers(vp.n_local))
            assert canon(a.fail_node(v)) == canon(b.fail_node(v))
        elif op == "restore":
            v = int(np.nonzero(~b.node_up)[0][0]) if (~b.node_up).any() else 0
            a.restore_node(v)
            b.restore_node(v)
        assert a.epoch == b.epoch
        np.testing.assert_array_equal(a.cap, b.cap)
        np.testing.assert_array_equal(a.bw, b.bw)
        b.check_invariants()
    assert canon([t for _, t in pa.flush()]) == canon([t for _, t in pb.flush()])
    assert canon(a.tickets) == canon(b.tickets)
    assert online_counters(a.stats) == online_counters(b.stats)
    assert bumped and b.stats.admitted and b.stats.stale_batches
    assert b.stats.mean_solve_n == vp.n_local


def test_region_local_snapshot_survives_a_commit_in_flight():
    """An n_r-sized dispatch keeps the residual it was dispatched on: a
    commit between dispatch and finalize does not reach the in-flight DP."""
    rg = T.waxman(20, seed=3)
    assign = RS.partition_regions(R.waxman(20, seed=3), 2, seed=0)
    view = T.compact_view(rg, assign, 0)
    members = np.nonzero(assign == 0)[0]
    rng = np.random.default_rng(0)
    dfs = [view.compact_df(port_df(_local_df(rng, members)))
           for _ in range(8)]
    placer = T.OnlinePlacer(rg, view=view, device="cpu")
    before = placer.residual_graph()
    pending = placer._dispatch_solve(dfs[:2])
    assert any(placer.admit(df) is not None for df in dfs[2:])
    assert placer.res.version > 0
    got, _ = pending.finalize()
    want, _ = engine.solve_batch(before, dfs[:2], device="cpu")
    assert all(same_mapping(x, y) for x, y in zip(got, want))
