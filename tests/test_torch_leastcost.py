"""The port's batched DP (``repro_torch.core.leastcost``) against the
reference's ``_leastcost_dp_batched(impl="ref")``: cold and warm-seeded
solves agree bit for bit in C, par_v, par_j, best_cost, best_j and the
round count; the warm fuse cuts at exactly ``max_rounds``; reconstructed
mappings and the B = 1 single-request path agree too."""
import numpy as np
import pytest

import repro.core as R
from repro.core import leastcost as rl
from repro.core.problem import stack_requests as ref_stack
from repro_torch.core import leastcost as tl
from repro_torch.core.problem import stack_requests as port_stack

from torch_parity import (assert_arrays_equal, light_stream, port_df,
                          port_graph, same_mapping)

DP_NAMES = ("C", "par_v", "par_j", "best_cost", "best_j")


def _both_dp(rg, dfs, max_rounds, seeds=None):
    B = len(dfs)
    tj, p_max = ref_stack(rg, dfs)
    tt, _ = port_stack(port_graph(rg), [port_df(d) for d in dfs], device="cpu")
    if seeds is not None:
        tj = dict(tj, **rl.stack_warm_seeds(seeds, B, p_max))
        tt = dict(tt, **tl.stack_warm_seeds(seeds, B, p_max, device="cpu"))
    ref = rl._leastcost_dp_batched(tj, B=B, n=rg.n, p=p_max,
                                   max_rounds=max_rounds, impl="ref")
    port = tl._leastcost_dp_batched(tt, B=B, n=rg.n, p=p_max,
                                    max_rounds=max_rounds, impl="plain")
    return ref, port


@pytest.mark.parametrize("n,ps,seed", [
    (12, [4, 6, 5, 3], 0),
    (16, [5, 5, 5], 7),
    (20, [3, 7, 4, 6, 2, 5], 21),
    (24, [8, 2, 8], 3),
])
def test_cold_batched_dp_matches_reference(n, ps, seed):
    rg = R.waxman(n, seed=seed)
    dfs = light_stream(rg, ps, seed0=1000 * seed)
    ref, port = _both_dp(rg, dfs, n - 1)
    assert_arrays_equal(ref[:5], port[:5], DP_NAMES)
    assert int(ref[5]) == port[5]


def _stale_seeds(rg, dfs):
    """Warm seeds from mappings solved on the base network, walked on a
    residual that has lost capacity and bandwidth (stale entries)."""
    maps = rl.leastcost_jax_batched(rg, dfs, use_kernel=True,
                                    kernel_impl="ref")
    cap = rg.cap * np.float32(0.6)
    bw = rg.bw * np.float32(0.7)
    shrunk = R.ResourceGraph(cap.astype(np.float32), bw.astype(np.float32),
                             rg.lat)
    ref = [None if m is None else rl.warm_seed_from_mapping(shrunk, d, m)
           for d, m in zip(dfs, maps)]
    port = [None if m is None else tl.warm_seed_from_mapping(
        port_graph(shrunk), port_df(d), m) for d, m in zip(dfs, maps)]
    for a, b in zip(ref, port):
        assert (a is None) == (b is None)
        if a is not None:
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    return shrunk, ref


@pytest.mark.parametrize("n,ps,seed,max_rounds", [
    (14, [5, 4, 6, 5], 2, 13),
    (16, [6, 6, 3], 5, 4),
    (18, [4, 8, 5], 8, 2),
])
def test_warm_batched_dp_matches_reference(n, ps, seed, max_rounds):
    rg = R.waxman(n, seed=seed)
    dfs = light_stream(rg, ps, seed0=70 + seed)
    shrunk, seeds = _stale_seeds(rg, dfs)
    assert any(s is not None for s in seeds)
    ref, port = _both_dp(shrunk, dfs, max_rounds, seeds=seeds)
    assert_arrays_equal(ref[:5], port[:5], DP_NAMES)
    assert int(ref[5]) == port[5] <= max_rounds


@pytest.mark.parametrize("max_rounds", [1, 2, 3, 4])
def test_fuse_cuts_at_exactly_max_rounds(max_rounds):
    """A cold solve that needs more rounds than the fuse stops at the fuse,
    in the same state as the reference."""
    rg = R.waxman(20, seed=21)
    dfs = light_stream(rg, [3, 7, 4, 6], seed0=21000)
    ref, port = _both_dp(rg, dfs, max_rounds)
    assert int(ref[5]) == port[5] == max_rounds
    assert_arrays_equal(ref[:5], port[:5], DP_NAMES)


@pytest.mark.parametrize("n,ps,seed", [(18, [3, 6, 4, 5, 6, 2], 2),
                                       (15, [5, 5, 5, 5, 5], 9)])
def test_batched_mappings_match_reference(n, ps, seed):
    rg = R.waxman(n, seed=seed)
    dfs = light_stream(rg, ps, seed0=70 + seed)
    st_ref, st_port = R.Stats(), tl.HeuristicStats()
    ref = rl.leastcost_jax_batched(rg, dfs, use_kernel=True,
                                   kernel_impl="ref", bucket_batch=True,
                                   stats=st_ref)
    port = tl.leastcost_torch_batched(port_graph(rg),
                                      [port_df(d) for d in dfs],
                                      device="cpu", bucket_batch=True,
                                      stats=st_port)
    assert any(m is not None for m in ref)
    assert all(same_mapping(a, b) for a, b in zip(ref, port))
    assert st_ref.rounds == st_port.rounds
    assert st_port.kernel_impl == "plain"


@pytest.mark.parametrize("n,p,seed", [(14, 5, 17), (12, 8, 4), (10, 2, 6)])
def test_single_request_matches_reference(n, p, seed):
    rg = R.waxman(n, seed=seed)
    df = light_stream(rg, [p], seed0=30 + seed)[0]
    m_ref, st_ref = rl.leastcost_jax(rg, df, use_kernel=True,
                                     kernel_impl="ref")
    m_port, st_port = tl.leastcost_torch(port_graph(rg), port_df(df),
                                         device="cpu")
    assert same_mapping(m_ref, m_port)
    assert (st_ref.rounds, st_ref.max_set_size) == (st_port.rounds,
                                                    st_port.max_set_size)
    assert st_port.kernel_impl == "plain"


def test_leastcost_python_copy_matches_reference():
    rg = R.waxman(10, seed=1)
    for i, p in enumerate([3, 5, 6]):
        df = R.random_dataflow(rg, p, seed=i)
        a, sa = rl.leastcost_python(rg, df)
        b, sb = tl.leastcost_python(port_graph(rg), port_df(df))
        assert same_mapping(a, b) and sa.rounds == sb.rounds
