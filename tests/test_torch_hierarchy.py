"""The port's hierarchical control plane (``ControlPlane(rg, levels=2)``)
against the reference: a seeded fuzz over a region tree, and a request
split at the top-level cut with its gateway failed and restored, step by
step, bit for bit (rids, tickets, ledgers at every level, span and gossip
counters, every leaf placer).  The port also keeps the reference's own
invariant: ``levels=1`` is the flat regional plane."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
import repro_torch.service as TS

from torch_planes import Lockstep, fuzz, make_pair


def _tree_pair(levels_phys, b, k, seed, **kw):
    rg, assign = R.region_tree(levels_phys, b, k, seed=seed)
    a, b_ = make_pair(rg, levels=2, region_of=assign, seed=seed, **kw)
    assert type(b_) is TS.HierarchicalControlPlane
    return rg, Lockstep(a, b_)


@pytest.mark.parametrize("seed", [0, 1])
def test_two_level_plane_fuzz_matches_reference(seed):
    rg, ls = _tree_pair(2, 3, 4, seed=3, policy=dict(slack=0.4),
                        micro_batch=6, max_attempts=3)
    ls.register_tenant("a", weight=3.0)
    ls.register_tenant("b", weight=1.0)
    ls.register_tenant("c", weight=2.0, budget=1.5)
    fuzz(ls, rg, seed, steps=50, cuts=ls.a.cut_base)
    b = ls.b
    assert b.levels == 2 and b.B == 3
    assert b.conservation()["submitted"] > 0


def test_top_level_span_and_gateway_failure_match_reference():
    rg, ls = _tree_pair(2, 4, 8, seed=0, micro_batch=8, max_attempts=4)
    ls.register_tenant("a")
    df = R.DataflowPath.make([0.0, 0.1, 0.1, 0.0], [0.5, 0.5, 0.5],
                             0, rg.n - 1)
    rid = ls.submit("a", df)
    (st,) = ls.pump()
    ls.check()
    assert st.rid == rid and len(st.parts) == 2
    b = ls.b
    assert b.B == 4 and b.group_of[0] != b.group_of[rg.n - 1]
    u, _ = st.cuts[0]
    ls.fail_node(u)
    ls.check()
    assert rid not in b._span_active
    ls.restore_node(u)
    got = ls.pump(rounds=4)
    ls.check()
    assert any(getattr(t, "rid", None) == rid for t in got)
    ls.release(rid)
    ls.check()
    assert b.coordination_report()["twopc_messages_total"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_levels1_plane_is_the_flat_regional_plane(seed):
    rg = T.waxman(14, seed=4)
    kw = dict(device="cpu", micro_batch=6, max_attempts=3, seed=seed)
    flat = TS.RegionalControlPlane(rg, regions=3,
                                   policy=TS.FairSharePolicy(slack=0.4), **kw)
    hier = TS.HierarchicalControlPlane(rg, levels=1, regions=3,
                                       policy=TS.FairSharePolicy(slack=0.4),
                                       **kw)
    assert hier.B == 1 and hier.children[0].R == 3
    ls = Lockstep(flat, hier, to_b=lambda df: df, full=False)
    ls.register_tenant("a", weight=3.0)
    ls.register_tenant("b", weight=1.0)
    fuzz(ls, rg, seed, steps=50, tenants=("a", "b"), cuts=flat.cut_base)
    assert flat.cut_residual == hier.children[0].cut_residual
    assert hier.bus.messages_sent == 0 and hier._twopc_msgs == 0
    assert (hier.engine_stats().twopc_messages
            == flat.engine_stats().twopc_messages)
    assert np.sum([p.stats.solves for p in
                   (cp.placer for cp in flat.regions)]) > 0
