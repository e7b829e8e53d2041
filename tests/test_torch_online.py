"""One seeded admit / release / churn / restore script through the
reference ``OnlinePlacer(use_kernel=True, kernel_impl="ref")`` and the
port's ``OnlinePlacer(device="cpu")``, behind admission pipelines of depth
1 and 3 with the solution cache on: tickets, tids, residual arrays and every
``OnlineStats`` counter agree (wall clock excluded; the kernel label is
"ref" on one side and "plain" on the other)."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T

from torch_parity import port_df, port_graph, same_mapping

WALL_CLOCK = ("solve_ms", "overhead_ms", "conflict_resolve_ms")


def _counters(stats, label):
    d = dataclasses.asdict(stats)
    for k in WALL_CLOCK:
        d.pop(k)
    d["kernel_impls"] = {("impl" if k == label else k): v
                         for k, v in d["kernel_impls"].items()}
    return d


def _assert_same_tickets(ta, tb):
    assert [t and t.tid for t in ta] == [t and t.tid for t in tb]
    for x, y in zip(ta, tb):
        if x is not None:
            assert same_mapping(x.mapping, y.mapping)
            assert dict(x.node_load) == dict(y.node_load)
            assert dict(x.edge_load) == dict(y.edge_load)


def _assert_same_state(a, b):
    assert sorted(a.tickets) == sorted(b.tickets)
    for tid, t in a.tickets.items():
        assert same_mapping(t.mapping, b.tickets[tid].mapping)
    np.testing.assert_array_equal(a.cap, b.cap)
    np.testing.assert_array_equal(a.bw, b.bw)
    np.testing.assert_array_equal(a.node_up, b.node_up)
    np.testing.assert_array_equal(a.link_up, b.link_up)
    assert a.epoch == b.epoch


@pytest.mark.parametrize("depth,seed", [(1, 0), (3, 1)])
def test_online_script_matches_reference(depth, seed):
    rng = np.random.default_rng(seed)
    rg = R.waxman(14, seed=5 + seed)
    pool = [R.random_dataflow(rg, 5, seed=100 * seed + i,
                              creq_range=(0.1, 0.8), breq_range=(1.0, 12.0))
            for i in range(14)]
    a = R.OnlinePlacer(rg, use_kernel=True, kernel_impl="ref")
    b = T.OnlinePlacer(port_graph(rg), device="cpu")
    pa, pb = R.AdmissionPipeline(a, depth), T.AdmissionPipeline(b, depth)
    edges = list(rg.edges())
    failed_nodes, failed_links, snaps = [], [], []

    for step in range(45):
        op = rng.choice(
            ["admit", "release", "fail_node", "restore_node", "fail_link",
             "restore_link", "snapshot", "restore"],
            p=[0.5, 0.2, 0.06, 0.06, 0.05, 0.05, 0.04, 0.04])
        if op == "admit":
            batch = [pool[i] for i in rng.integers(0, len(pool),
                                                   int(rng.integers(1, 7)))]
            oa = pa.push(batch)
            ob = pb.push([port_df(d) for d in batch])
            assert len(oa) == len(ob)
            for (_, ta), (_, tb) in zip(oa, ob):
                _assert_same_tickets(ta, tb)
        elif op == "release" and a.tickets:
            tid = int(rng.choice(sorted(a.tickets)))
            a.release(tid)
            b.release(tid)
        elif op == "fail_node" and len(failed_nodes) < 2:
            v = int(rng.integers(rg.n))
            if v not in failed_nodes:
                ra, da = a.fail_node(v)
                rb, db = b.fail_node(v)
                _assert_same_tickets(ra, rb)
                assert [t.tid for t in da] == [t.tid for t in db]
                failed_nodes.append(v)
        elif op == "restore_node" and failed_nodes:
            v = failed_nodes.pop(int(rng.integers(len(failed_nodes))))
            a.restore_node(v)
            b.restore_node(v)
        elif op == "fail_link" and len(failed_links) < 2:
            u, v = edges[int(rng.integers(len(edges)))]
            ra, da = a.fail_link(u, v)
            rb, db = b.fail_link(u, v)
            _assert_same_tickets(ra, rb)
            failed_links.append((u, v))
        elif op == "restore_link" and failed_links:
            u, v = failed_links.pop(int(rng.integers(len(failed_links))))
            a.restore_link(u, v)
            b.restore_link(u, v)
        elif op == "snapshot":
            snaps = [(a.snapshot(), b.snapshot(), list(failed_nodes),
                      list(failed_links))]
        elif op == "restore" and snaps:
            sa, sb, failed_nodes, failed_links = snaps[0]
            failed_nodes, failed_links = list(failed_nodes), list(failed_links)
            a.restore(sa)
            b.restore(sb)
        _assert_same_state(a, b)
        b.check_invariants()

    for (_, ta), (_, tb) in zip(pa.flush(), pb.flush()):
        _assert_same_tickets(ta, tb)
    _assert_same_state(a, b)
    ca, cb = _counters(a.stats, "ref"), _counters(b.stats, "plain")
    assert ca == cb
    # the script reached every admission path the cache has
    assert cb["cache_hits"] and cb["cache_stale"] and cb["warm_solves"]
    assert "cold" in cb["supersteps"] and "warm" in cb["supersteps"]
    assert set(b.stats.kernel_impls) == {"plain"}


def test_warmup_commits_nothing_and_touches_no_stats():
    rg = T.waxman(12, seed=3)
    placer = T.OnlinePlacer(rg, device="cpu")
    assert placer.warmup(max_batch=8, p=5) == 8
    np.testing.assert_array_equal(placer.cap, rg.cap.astype(np.float64))
    assert placer.stats == T.OnlineStats()
    assert placer.res.version == 0 and not placer.tickets
