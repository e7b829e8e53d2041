"""The port's residual mirror (``repro_torch.core.residual``): delta-synced
device tensors equal the reference's bit for bit after the same sequence;
an in-flight solve keeps the residual it was dispatched on; and a residual
carried across from the reference (``core.carry``) admits identically."""
import numpy as np
import pytest

import repro.core as R
from repro.core.residual import ResidualState as RefResidual
from repro_torch.core import engine, leastcost as tl
from repro_torch.core import OnlinePlacer, ResidualState
from repro_torch.core.carry import graph_from_numpy, residual_from_snapshot

from torch_parity import light_stream, port_df, port_graph, same_mapping


def _random_loads(rng, rg):
    edges = list(rg.edges())
    nodes = {int(v): float(rng.uniform(0.01, 0.5))
             for v in rng.choice(rg.n, size=3, replace=False)}
    picks = rng.choice(len(edges), size=4, replace=False)
    links = {edges[i]: float(rng.uniform(0.1, 3.0)) for i in picks}
    return nodes, links


def _assert_mirror_equal(a, b):
    da, db = a.device_tensors(), b.device_tensors()
    for k in ("cap", "bw", "lat"):
        np.testing.assert_array_equal(np.asarray(da[k]), db[k].numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(a.cap, b.cap)
    np.testing.assert_array_equal(a.bw, b.bw)
    assert (a.version, a.epoch) == (b.version, b.epoch)


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_synced_mirror_bitwise_equals_reference(seed):
    rng = np.random.default_rng(seed)
    rg = R.waxman(14, seed=seed)
    a, b = RefResidual(rg), ResidualState(port_graph(rg), device="cpu")
    _assert_mirror_equal(a, b)
    held = []
    for step in range(40):
        op = rng.choice(["commit", "release", "sync", "fail", "restore"],
                        p=[0.45, 0.25, 0.2, 0.05, 0.05])
        if op == "commit":
            loads = _random_loads(rng, rg)
            held.append(loads)
            a.apply_load(*loads, -1.0)
            b.apply_load(*loads, -1.0)
        elif op == "release" and held:
            loads = held.pop(int(rng.integers(len(held))))
            a.apply_load(*loads, 1.0)
            b.apply_load(*loads, 1.0)
        elif op == "sync":
            _assert_mirror_equal(a, b)
        elif op == "fail":
            v = int(rng.integers(rg.n))
            a.set_node_up(v, False)
            b.set_node_up(v, False)
        elif op == "restore":
            snap = a.snapshot()
            a.restore(snap)
            b.restore(snap)
    _assert_mirror_equal(a, b)
    assert b.sync_stats["delta_syncs"] > 0


def test_in_flight_solve_keeps_its_dispatch_residual(monkeypatch):
    """dispatch -> commit another ticket (synced to the device) -> finalize
    equals a synchronous solve on the dispatch-time residual, although
    finalize enqueues every superstep after the first."""
    monkeypatch.setattr(tl, "CHUNK", 1)
    rg, _ = R.region_line(5, 4, seed=3)
    placer = OnlinePlacer(port_graph(rg), device="cpu", cache_enabled=False)
    far = [port_df(R.DataflowPath.make([0.0, 0.3, 0.4, 0.2, 0.0],
                                       [1.0] * 4, src=s, dst=d))
           for s, d in ((0, 19), (1, 18), (2, 17))]
    rg0 = placer.residual_graph()
    gt = placer.res.device_tensors()
    cap0 = gt["cap"].clone()
    pending = engine.solve_batch_dispatch(
        rg0, far, graph_tensors=gt, device="cpu", bucket_batch=True)
    # a commit on the very nodes the batch needs, pushed to the device
    hog = port_df(R.DataflowPath.make([0.0] + [1.5] * 6 + [0.0], [1.0] * 7,
                                      src=0, dst=19))
    assert placer.admit(hog) is not None
    new = placer.res.device_tensors()
    assert not np.array_equal(new["cap"].numpy(), cap0.numpy())
    got, st = pending.finalize()
    want, st_sync = engine.solve_batch(rg0, far, device="cpu")
    assert st.rounds == st_sync.rounds > 1
    assert all(same_mapping(a, b) for a, b in zip(got, want))
    assert np.array_equal(gt["cap"].numpy(), cap0.numpy())  # untouched


def test_carry_round_trip_admits_identically():
    rg = R.waxman(16, seed=6)
    ref = R.OnlinePlacer(rg, use_kernel=True, kernel_impl="ref")
    ref.admit_many(light_stream(rg, [4, 5, 4, 6], seed0=300))
    snap = ref.res.snapshot()

    ref2 = R.OnlinePlacer(rg, use_kernel=True, kernel_impl="ref")
    ref2.res.restore(snap)
    base = dict(cap=rg.cap, bw=rg.bw, lat=rg.lat)
    port = OnlinePlacer(graph_from_numpy(**base), device="cpu")
    port.res = residual_from_snapshot(base, snap, device="cpu")
    np.testing.assert_array_equal(port.cap, ref2.cap)
    np.testing.assert_array_equal(port.bw, ref2.bw)

    batch = light_stream(rg, [5, 4, 6, 3, 5], seed0=400)
    ta = ref2.admit_many(batch)
    tb = port.admit_many([port_df(d) for d in batch])
    assert any(t is not None for t in ta)
    for x, y in zip(ta, tb):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.tid == y.tid and same_mapping(x.mapping, y.mapping)
    np.testing.assert_array_equal(port.cap, ref2.cap)
    np.testing.assert_array_equal(port.bw, ref2.bw)

    # and the port's own snapshot carries back into a fresh port residual
    again = residual_from_snapshot(base, port.res.snapshot(), device="cpu")
    np.testing.assert_array_equal(again.cap, port.cap)
    np.testing.assert_array_equal(again.bw, port.bw)
    with pytest.raises(KeyError):
        residual_from_snapshot(base, {"cap": snap["cap"]}, device="cpu")
