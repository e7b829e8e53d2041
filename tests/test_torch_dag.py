"""The port's tree-dataflow DP (``repro_torch.core.dag``) against the
reference on the cases of ``tests/test_dag.py``: the same mapping (assign,
cost, validity, routes) bit for bit, from ``treemap_leastcost`` and from
``treemap_fixed`` on the assignment it found."""
import numpy as np
import pytest

import repro.core as R
import repro.core.dag as RD
import repro_torch.core as T
import repro_torch.core.dag as TD

from torch_parity import port_graph
from torch_planes import canon


def _two_sources_merge():
    return R.waxman(15, seed=7), dict(
        creq=np.array([0.0, 0.0, 2.0, 0.0], np.float32),
        parent=np.array([2, 2, 3, -1]),
        breq=np.array([20.0, 20.0, 30.0, 0.0], np.float32),
        pinned={0: 0, 1: 1, 3: 2})


def _path(seed):
    rg = R.waxman(12, seed=seed)
    src, dst = np.random.default_rng(seed).choice(rg.n, 2, replace=False)
    return rg, dict(
        creq=np.array([0.0, 1.5, 1.0, 0.0], np.float32),
        parent=np.array([1, 2, 3, -1]),
        breq=np.array([20.0, 25.0, 15.0, 0.0], np.float32),
        pinned={0: int(src), 3: int(dst)})


def _capacity_repair():
    return R.waxman(10, seed=3, cap_range=(3.0, 3.0)), dict(
        creq=np.array([0.0, 2.0, 2.0, 0.0], np.float32),
        parent=np.array([1, 2, 3, -1]),
        breq=np.array([20.0, 20.0, 20.0, 0.0], np.float32),
        pinned={0: 0, 3: 5})


def _paper_fig2():
    rg, _ = R.paper_example()
    return rg, dict(
        creq=np.array([0, 0, 0, 2.0, 1.5, 0], np.float32),
        parent=np.array([3, 4, 3, 4, 5, -1]),
        breq=np.array([20.0, 20.0, 20.0, 25.0, 20.0, 0.0], np.float32),
        pinned={0: 0, 1: 0, 2: 1, 5: 5})


CASES = {"two_sources_merge": _two_sources_merge,
         **{f"path_{s}": (lambda s=s: _path(s)) for s in range(6)},
         "capacity_repair": _capacity_repair,
         "paper_fig2": _paper_fig2}


@pytest.mark.parametrize("case", list(CASES))
def test_treemap_matches_reference(case):
    rg, kw = CASES[case]()
    ref = RD.treemap_leastcost(rg, RD.DataflowTree(**kw))
    tree = T.DataflowTree(**kw)
    got = T.treemap_leastcost(port_graph(rg), tree)
    assert canon(got) == canon(ref)
    if ref is not None:
        assert (canon(TD.treemap_fixed(port_graph(rg), tree, got.assign))
                == canon(RD.treemap_fixed(rg, RD.DataflowTree(**kw),
                                          ref.assign)))
    if case in ("two_sources_merge", "paper_fig2"):
        assert got is not None and got.valid
