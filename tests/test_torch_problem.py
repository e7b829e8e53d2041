"""Request tensors of the port (``repro_torch.core.problem``) against the
reference's: same constants, and bitwise-equal stacked tensors on mixed-p
batches, with and without batch padding."""
import numpy as np
import pytest

import repro.core as R
from repro.core import problem as rp
from repro_torch.core import problem as tp

from torch_parity import assert_arrays_equal, port_df, port_graph

KEYS = ("cap", "bw", "lat", "prefix", "breq", "src", "dst", "p_eff")


def test_constants_copied_exactly():
    assert tp.BIG == rp.BIG and tp.BIG.dtype == rp.BIG.dtype
    for name in ("EPS_CAP", "EPS_CAP_F32", "EPS_BW", "EPS_COST", "EPS_IMPROVE"):
        assert getattr(tp, name) == getattr(rp, name), name


@pytest.mark.parametrize("n,ps,pad_to,seed", [
    (10, [4, 6, 3], None, 0),
    (14, [2, 8, 5, 5], None, 1),
    (12, [3, 7, 4], 8, 2),
    (9, [5], 4, 3),
])
def test_stack_requests_matches_reference(n, ps, pad_to, seed):
    rg = R.waxman(n, seed=seed)
    dfs = [R.random_dataflow(rg, p, seed=100 * seed + i)
           for i, p in enumerate(ps)]
    ref, p_ref = rp.stack_requests(rg, dfs, pad_to=pad_to)
    port, p_port = tp.stack_requests(port_graph(rg), [port_df(d) for d in dfs],
                                     pad_to=pad_to, device="cpu")
    assert p_ref == p_port
    assert_arrays_equal([ref[k] for k in KEYS], [port[k] for k in KEYS], KEYS)
    for k in ("cap", "bw", "lat", "prefix", "breq"):
        assert str(port[k].dtype) == "torch.float32", k
    for k in ("src", "dst", "p_eff"):
        assert str(port[k].dtype) == "torch.int32", k


def test_problem_tensors_and_pad_request_match_reference():
    rg = R.waxman(11, seed=4)
    df = R.random_dataflow(rg, 5, seed=9)
    ref = rp.problem_tensors(rg, df)
    port = tp.problem_tensors(port_graph(rg), port_df(df), device="cpu")
    assert_arrays_equal([ref[k] for k in KEYS], [port[k] for k in KEYS], KEYS)
    for p_max in (5, 7):
        a = rp.pad_request(df, p_max)
        b = tp.pad_request(port_df(df), p_max)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
