"""The port's decentralized BSP engine against the reference's
``leastcost_shard_map``: mappings and every ``DistStats`` field, bitwise, at
D = 1 in process and at D = 2 and 4 (port ranks over gloo in one
subprocess, the reference on forced host devices in another), plus the
superstep state itself, step by step."""
import dataclasses
import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import repro.core as R
from repro.core import distributed as rdist
from repro_torch.core import distributed as tdist
from repro_torch.core import engine
from repro_torch.kernels.minplus import minplus as tmp

from torch_parity import port_df, port_graph

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every DistStats field; kernel_impl names the reference's move, not a result
REF_FIELDS = [f.name for f in dataclasses.fields(rdist.DistStats)
              if f.name != "kernel_impl"]


def cases():
    yield "paper", *R.paper_example()
    for seed in range(6):
        rg = R.waxman(26, seed=seed)
        yield f"waxman26_{seed}", rg, R.random_dataflow(rg, 6, seed=seed + 11)


CASES = list(cases())


def record(m, st):
    out = {"stats": {k: getattr(st, k) for k in REF_FIELDS}}
    if m is not None:
        out.update(assign=list(m.assign), route=list(m.route), cost=m.cost)
    return out


@functools.cache
def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("nodes",))


@pytest.mark.parametrize("name,rg,df", CASES, ids=[c[0] for c in CASES])
def test_single_rank_matches_reference(name, rg, df):
    want = record(*rdist.leastcost_shard_map(rg, df, mesh=one_device_mesh()))
    got = record(*tdist.leastcost_shard_map(port_graph(rg), port_df(df),
                                            device="cpu"))
    assert got == want
    m, st = engine.solve(port_graph(rg), port_df(df), method="shard_map",
                         device="cpu")
    assert st.rounds == want["stats"]["supersteps"]
    assert st.messages_sent == want["stats"]["messages_total"]
    assert st.kernel_impl == "plain"
    if m is not None:
        assert (list(m.assign), list(m.route), m.cost) == (
            want["assign"], want["route"], want["cost"])


def _ref_superstep(mesh):
    """The reference's ``_dist_body`` on a one-device mesh."""
    body = functools.partial(rdist._dist_body, axis="nodes")
    rep = PartitionSpec()
    # no replication check (the flag's name depends on the jax release)
    kw = rdist._SHARD_MAP_KW or {"check_vma": False}
    return jax.jit(rdist._shard_map(body, mesh=mesh, in_specs=(rep,) * 12,
                                    out_specs=(rep,) * 6, **kw))


@pytest.mark.parametrize("seed", [1, 3])
def test_superstep_state_matches_reference_step_by_step(seed):
    """C, par_v, par_j and both message counts equal the reference after
    every superstep, although the kernel's move clamps BIG + lat and the
    reference's ``_local_move`` does not: the clamped entries never pass
    the update test.  Every pair gets bandwidth, one node loses its
    incoming links and the source hosts only the first dataflow node, so
    that node's column moves BIG + BIG and the clamp matters."""
    base = R.waxman(26, seed=seed)
    df = R.random_dataflow(base, 6, seed=seed + 11)
    lat = base.lat.copy()
    lat[:, min({0, 1, 2} - {df.src, df.dst})] = np.inf
    cap = base.cap.copy()
    cap[df.src] = df.creq[0]
    rg = R.ResourceGraph(cap, np.full_like(base.bw, 1e3), lat)
    n, K = rg.n, df.p + 1
    lat = R.problem.finite_lat(rg)
    bw = rg.bw.astype(np.float32)
    cap = rg.cap.astype(np.float32)
    prefix = R.problem.creq_prefix(df).astype(np.float32)
    breq_k = np.concatenate([[R.BIG], df.breq, [R.BIG]]).astype(np.float32)
    finite_edge = np.isfinite(rg.lat) & ~np.eye(n, dtype=bool)
    deg = finite_edge.sum(1).astype(np.float32)
    C = np.full((n, K), R.BIG, np.float32)
    C[df.src, 0] = 0.0
    pv = np.full((n, K), -1, np.int32)
    graph = [jnp.asarray(x) for x in (cap, lat, bw, prefix, breq_k, deg)]
    graph.append(jnp.zeros(n, jnp.float32))
    ref = [jnp.asarray(C), jnp.asarray(pv), jnp.asarray(pv),
           jnp.float32(0), jnp.float32(0)]
    t_graph = [torch.from_numpy(x) for x in (cap, lat, bw, prefix, breq_k)]
    t_graph.append(torch.from_numpy(np.stack([deg, np.zeros_like(deg)], 1)))
    port = [torch.from_numpy(C), torch.from_numpy(pv), torch.from_numpy(pv),
            torch.zeros(2)]
    step = _ref_superstep(one_device_mesh())
    raw_move = jax.jit(lambda C: rdist._local_move(
        R.leastcost._place_step(C, graph[0], graph[3])[0], *graph[1:3],
        graph[4]))
    clamped = 0
    for t in range(n - 1):
        # the two moves differ only at entries above BIG
        raw = np.asarray(raw_move(ref[0])[0])
        P, _ = tdist._place_step(port[0], t_graph[0], t_graph[3])
        ours = tmp.masked_minplus_plain(P, *t_graph[1:3], t_graph[4])[0]
        low = raw <= R.BIG
        np.testing.assert_array_equal(raw[low], ours.numpy()[low])
        assert (ours.numpy()[~low] == R.BIG).all()
        clamped += int((~low).sum())

        Cr, pvr, pjr, mt, mx, ch = step(*ref, *graph)
        Cp, pvp, pjp, msgs, chp = tdist._dist_body(
            *port, *t_graph, move=tmp.masked_minplus_plain, group=None, D=1)
        for a, b, what in ((Cr, Cp, "C"), (pvr, pvp, "par_v"),
                           (pjr, pjp, "par_j")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{what} at t={t}")
        assert float(mt) == float(msgs[0]) and float(mx) == float(msgs[1])
        assert bool(ch) == bool(chp)
        ref = [Cr, pvr, pjr, mt, mx]
        port = [Cp, pvp, pjp, msgs]
        if not bool(ch):
            break
    assert clamped > 0, "the instance never exercised the BIG clamp"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


REF_CODE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax
    import numpy as np
    from jax.sharding import Mesh
    import repro.core as R
    from repro.core.distributed import leastcost_shard_map

    assert jax.device_count() == 4
    results = {}
    for D in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:D]), ("nodes",))
        cases = [("paper", *R.paper_example())]
        for seed in range(6):
            rg = R.waxman(26, seed=seed)
            cases.append((f"waxman26_{seed}", rg,
                          R.random_dataflow(rg, 6, seed=seed + 11)))
        for name, rg, df in cases:
            m, st = leastcost_shard_map(rg, df, mesh=mesh)
            out = {"stats": dataclasses.asdict(st)}
            if m is not None:
                out.update(assign=list(m.assign), route=list(m.route),
                           cost=m.cost)
            results[f"{D}/{name}"] = out
    print("RESULT " + json.dumps(results), flush=True)
""")


def _result(proc, what):
    out, err = proc.communicate(timeout=240)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, f"{what} failed:\n{err[-3000:]}"
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module", autouse=True)
def multi_rank_runs():
    """Start both multi-rank subprocesses when the module starts, so they
    run while the single-rank tests do."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    kw = dict(cwd=ROOT, env=env, stdout=subprocess.PIPE,
              stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen([sys.executable, "-c", REF_CODE], **kw)
    port = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "torch_dist_worker.py"),
                             str(_free_port())], **kw)
    yield ref, port
    for proc in (ref, port):
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def multi_rank_results(multi_rank_runs):
    ref, port = multi_rank_runs
    return _result(ref, "reference"), _result(port, "port ranks")


@pytest.mark.parametrize("D", [2, 4])
def test_multi_rank_gloo_matches_reference_mesh(multi_rank_results, D):
    ref, port = multi_rank_results
    keys = sorted(k for k in ref if k.startswith(f"{D}/"))
    assert len(keys) == len(CASES)
    crossed = 0
    for key in keys:
        want, got = ref[key], port[key]
        for rec in (want, got):
            rec["stats"] = {k: rec["stats"][k] for k in REF_FIELDS}
        assert got == want, key
        crossed += want["stats"]["messages_cross_device"]
    assert crossed > 0  # the partition really split the flood
