"""The port's cost model (``repro_torch.launch.hlo_cost``) against
analytically known counts: the four tests of ``tests/test_hlo_cost.py`` at
their sizes and their ``rel=0.05`` (eager loops are dispatched trip by
trip, so the counts are exact), the byte rules on one device, and the
per-device counts on a fake 256-rank (16, 16) mesh.

The mesh cases run in one subprocess (``torch_cost_worker.py``), so that
no ``fake`` process group is left in a pytest worker: a ``Shard(0)`` x
``Shard(1)`` matmul counts its local product, 16,384 FLOPs, not the global
4,194,304 nor both (4,210,688); a replicated one counts whole; a
contraction over a sharded dimension issues one all-reduce of the local
output's bytes; a view of a DTensor moves nothing; and a train step's
microbatch loop run as one trip weighted by ``n_acc`` = 2 counts what
running both trips counts, but for the loss's running sum: the first trip
does no ``lsum + l`` (one float32 scalar add: 12 bytes, 1 operator)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import hlo_cost

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_loop_flops_scale_with_trip_count():
    n, d, trips = 64, 128, 12
    w, x = torch.randn(trips, d, d), torch.randn(n, d)

    def looped(w, x):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    r = hlo_cost.analyze(looped, w, x)
    expect = 2 * n * d * d * trips
    assert r["flops"] == pytest.approx(expect, rel=0.05), (r["flops"], expect)


def test_unrolled_equals_looped_flops():
    n, d, trips = 32, 64, 6
    w, x = torch.randn(trips, d, d), torch.randn(n, d)

    def looped(w, x):
        for wi in w.unbind(0):
            x = x @ wi
        return x

    def unrolled(w, x):
        x = x @ w[0]
        x = x @ w[1]
        x = x @ w[2]
        x = x @ w[3]
        x = x @ w[4]
        return x @ w[5]

    rl = hlo_cost.analyze(looped, w, x)
    ru = hlo_cost.analyze(unrolled, w, x)
    assert rl["flops"] == pytest.approx(ru["flops"], rel=0.05)


def test_nested_loops_multiply():
    d, outer, inner = 32, 5, 7
    w, x = torch.randn(outer, inner, d, d), torch.randn(d, d)

    def fn(w, x):
        for wo in w:
            for wi in wo:
                x = x @ wi
        return x

    r = hlo_cost.analyze(fn, w, x)
    assert r["flops"] == pytest.approx(2 * d ** 3 * outer * inner, rel=0.05)


def test_one_device_has_no_collective():
    a = torch.randn(128, 128)
    r = hlo_cost.analyze(lambda a: a @ a, a)
    assert r["collective_bytes_total"] == 0
    assert r["flops"] == pytest.approx(2 * 128 ** 3, rel=0.05)
    assert r["bytes_hbm"] > 0
    assert set(r) == {"flops", "bytes_hbm", "collectives",
                      "collective_bytes_total", "top_collectives",
                      "warnings", "n_computations"}


def test_byte_rules_views_slice_writes_and_reads():
    buf = torch.zeros(64, 32)
    upd = torch.ones(4, 32)
    idx = torch.tensor([1, 5, 9])
    f32 = 4
    # views, aliases, expand and detach move nothing
    r = hlo_cost.analyze(lambda t: (t.view(32, 64), t.t(), t[2:6], t.detach(),
                                    t[:, :1].expand(64, 8)), buf)
    assert r["bytes_hbm"] == 0 and r["n_computations"] >= 5
    # an in-place write into a slice: twice the update
    r = hlo_cost.analyze(lambda b, u: b[8:12].copy_(u), buf, upd)
    assert r["bytes_hbm"] == 2 * upd.numel() * f32
    r = hlo_cost.analyze(lambda b, u: b.index_copy_(0, idx, u[:3]), buf, upd)
    assert r["bytes_hbm"] == 2 * 3 * 32 * f32
    # a gather/index read: twice the result, not the table
    r = hlo_cost.analyze(lambda b: b[idx], buf)
    assert r["bytes_hbm"] == 2 * 3 * 32 * f32
    # an elementwise op: its operands and result; a broadcast operand once
    r = hlo_cost.analyze(lambda b, s: b * s, buf, torch.ones(1, 32))
    assert r["bytes_hbm"] == (64 * 32 + 32 + 64 * 32) * f32
    assert r["flops"] == 0  # no elementwise FLOPs, as in the reference


def test_copy_between_devices_is_counted_apart():
    """A copy to another device (a card's upload of a host-built table)
    moves none of the step's device memory: counted in ``transfer_bytes``
    so that a card's count equals the CPU's."""
    x = torch.ones(16, 8)
    with hlo_cost.Counters() as c:
        (x.to("meta") * 2).to(torch.float16)
    assert c.transfer_bytes == x.numel() * 4
    assert c.bytes_hbm == (2 * 16 * 8 * 4) + (16 * 8 * 4 + 16 * 8 * 2)
    assert c.by_op["transfer aten._to_copy"][0] == 1


def test_memory_tracks_arguments_temporaries_and_aliases():
    w, x = torch.randn(3, 16, 16), torch.randn(8, 16)
    cache = torch.zeros(4, 16)

    def step(w, x, cache):
        for i in range(3):
            x = x @ w[i]
        cache[:2].copy_(x[:2, :])
        return x, cache

    with hlo_cost.Counters() as c:
        c.arguments(w, x, cache)
        out = step(w, x, cache)
        c.outputs(out)
    mem = c.memory()
    assert mem["argument_bytes"] == (3 * 16 * 16 + 8 * 16 + 4 * 16) * 4
    assert mem["alias_bytes"] == cache.numel() * 4
    assert mem["output_bytes"] == (8 * 16 + 4 * 16) * 4
    assert mem["temp_bytes"] == 2 * 8 * 16 * 4  # two products live at once
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


def test_argument_bytes_count_only_the_leaves_read():
    """An argument counts when an operator reads it: ``unused`` is never
    read; ``state`` is overwritten whole (in two ``copy_``s) before any
    read; ``cache`` is updated in part (``index_copy_`` keeps the rest);
    ``half`` is returned with half of it overwritten (the rest flows to
    the output), as XLA keeps exactly ``w``, ``cache`` and ``half``."""
    w, unused = torch.randn(16, 16), torch.randn(8)
    state, cache, half = torch.zeros(2, 4), torch.zeros(4, 4), torch.zeros(4)

    def step(w, unused, state, cache, half):
        x = torch.ones(3, 16) @ w
        state[0].copy_(x[0, :4])
        state[1].copy_(x[1, :4])
        y = state.sum()  # reads what the step wrote, not the argument
        cache.index_copy_(0, torch.tensor([1]), x[:1, :4])
        half[:2].copy_(x[2, :2])
        return x + y, state, cache, half

    with hlo_cost.Counters() as c:
        c.arguments(w, unused, state, cache, half)
        out = step(w, unused, state, cache, half)
        c.outputs(out)
    assert [c.read(t) for t in (w, unused, state, cache, half)] == [
        True, False, False, True, True]
    assert c.memory()["argument_bytes"] == (16 * 16 + 4 * 4 + 4) * 4


@pytest.fixture(scope="module")
def mesh_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("cost") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(ROOT / "tests/torch_cost_worker.py"),
                        str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(out.read_text())


def case(mesh_counts, name):
    got = mesh_counts[name]
    assert "error" not in got, got.get("error")
    return got


def test_sharded_matmul_counts_the_local_product(mesh_counts):
    r = case(mesh_counts, "sharded_mm")
    # (64, 128) Shard(0) over data x (128, 256) Shard(1) over model:
    # rank 0 multiplies (4, 128) @ (128, 16)
    assert r["flops"] == 2 * 4 * 128 * 16 == 16_384
    assert r["collective_bytes_total"] == 0 and r["n_computations"] == 1


def test_replicated_matmul_counts_whole(mesh_counts):
    r = case(mesh_counts, "replicated_mm")
    assert r["flops"] == 2 * 64 * 128 * 256
    assert r["collective_bytes_total"] == 0


def test_sharded_contraction_issues_one_all_reduce(mesh_counts):
    r = case(mesh_counts, "contraction")
    assert r["flops"] == 2 * 64 * (128 // 16) * 256
    assert r["collectives"]["all-reduce"] == {"count": 1.0,
                                              "bytes": 64 * 256 * 4}
    assert r["collective_bytes_total"] == 64 * 256 * 4
    assert r["top_collectives"][0]["kind"] == "all-reduce"
    assert r["warnings"] == []


def test_dtensor_view_moves_nothing(mesh_counts):
    r = case(mesh_counts, "dtensor_view")
    assert r["bytes_hbm"] == 0 and r["flops"] == 0


def test_shard_to_shard_counts_one_all_to_all(mesh_counts):
    """A redistribute between two sharded dimensions is one all-to-all of
    the local shard, (4, 128) float32, whatever the device runs in its
    place (gloo's all-gather and chunk here, moving and counted nothing
    more)."""
    r = case(mesh_counts, "shard_to_shard")
    assert r["collectives"]["all-to-all"] == {"count": 1.0,
                                              "bytes": 4 * 128 * 4}
    assert r["collective_bytes_total"] == 4 * 128 * 4
    assert r["collectives"]["all-gather"]["count"] == 0
    # the shard read and the new one written
    assert r["bytes_hbm"] == 2 * 4 * 128 * 4
    assert r["flops"] == 0 and r["warnings"] == []


def test_one_trip_weighted_by_n_acc_equals_both_trips(mesh_counts):
    r = case(mesh_counts, "n_acc")
    assert r["n_acc"] == 2
    full, one = r["full"], r["one_trip"]
    assert one["flops"] == full["flops"] > 0
    assert one["collectives"] == full["collectives"]
    assert one["transcendentals"] == full["transcendentals"]
    # the loss's running sum: trip 2 adds two float32 scalars
    assert full["bytes_hbm"] - one["bytes_hbm"] == 12
    assert full["n_computations"] - one["n_computations"] == 1
