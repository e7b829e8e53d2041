"""The port's regional control plane (``ControlPlane(rg, region_of=...)``)
against the reference: an R = 4 line of regions whose spanning requests
cross multi-hop region chains by two-phase commit, with cut links failed
and healed, step by step.  Rids, tickets (spanning ones with their parts,
cuts and view versions), ledgers, ``span_stats``, gossip counts and every
placer's residuals and counters agree bit for bit.  The port also keeps
the reference's own invariant: at R = 1 the regional plane is the
centralized one."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
import repro_torch.service as TS

from torch_planes import Lockstep, fuzz, make_pair


def _line_pair(R_, k, seed, **kw):
    rg, assign = R.region_line(R_, k, seed=seed)
    a, b = make_pair(rg, policy=dict(slack=0.4), region_of=assign,
                     micro_batch=6, max_attempts=3, seed=seed, fanout=1, **kw)
    ls = Lockstep(a, b)
    ls.register_tenant("a", weight=3.0)
    ls.register_tenant("b", weight=1.0)
    ls.register_tenant("c", weight=2.0, budget=2.0)
    return rg, assign, ls


def _far_spanning(assign, R_):
    def df_gen(rng, step):
        # half the requests run from region 0 to the last region
        if rng.random() < 0.5:
            r1, r2 = 0, R_ - 1
        else:
            r1, r2 = rng.choice(R_, size=2, replace=False)
        src = int(rng.choice(np.nonzero(assign == r1)[0]))
        dst = int(rng.choice(np.nonzero(assign == r2)[0]))
        p = int(rng.integers(2, 6))
        creq = rng.uniform(0.02, 0.15, p).astype(np.float32)
        creq[0] = creq[-1] = 0.0
        breq = rng.uniform(0.5, 2.0, p - 1).astype(np.float32)
        return R.DataflowPath(creq, breq, src, dst)
    return df_gen


def test_multi_hop_spanning_request_and_cut_failure_match_reference():
    rg, assign, ls = _line_pair(4, 4, seed=0)
    df = R.DataflowPath.make([0.0, 0.2, 0.2, 0.2, 0.0], [1.0] * 4,
                             src=0, dst=rg.n - 1)
    rid = ls.submit("a", df, klass=1)
    (t,) = ls.pump()
    ls.check()
    assert t.chain == [0, 1, 2, 3] and ls.b.span_stats["multi_hop"] == 1
    alive, requeued = ls.fail_link(*t.cuts[1])
    ls.check()
    assert alive == [] and len(requeued) == 4
    ls.pump()
    assert ls.b.conservation()["active"] == 0
    ls.restore_link(*t.cuts[1])
    out = ls.pump()
    ls.check()
    assert [s.rid for s in out] == [rid]
    ls.release(rid)
    ls.check()
    assert ls.b.coordination_report()["gossip_messages"] > 0


@pytest.mark.parametrize(("seed", "depth"), [(4, 1), (5, 2)])
def test_regional_plane_fuzz_matches_reference(seed, depth):
    rg, assign, ls = _line_pair(4, 3, seed=seed, pipeline_depth=depth)
    fuzz(ls, rg, seed, steps=45, df_gen=_far_spanning(assign, 4),
         cuts=ls.a.cut_base)
    b = ls.b
    assert b.conservation()["submitted"] > 0
    assert b.span_stats["max_chain"] >= 3 and b.span_stats["multi_hop"] >= 1
    assert b.engine_stats().twopc_messages > 0
    assert b.solve_size_report()["max_solve_n"] <= 3


@pytest.mark.parametrize("seed", [0, 1])
def test_r1_regional_plane_is_the_centralized_plane(seed):
    """The reference's degenerate case, held in the port: one region under
    the identity view replays the centralized plane step by step."""
    rg = T.waxman(14, seed=5)
    kw = dict(device="cpu", micro_batch=6, max_attempts=3)
    cen = TS.ControlPlane(rg, policy=TS.FairSharePolicy(slack=0.4), **kw)
    reg = TS.RegionalControlPlane(rg, regions=1, seed=seed,
                                  policy=TS.FairSharePolicy(slack=0.4), **kw)
    assert reg.R == 1 and reg.views[0].is_identity
    ls = Lockstep(cen, reg, to_b=lambda df: df, full=False)
    ls.register_tenant("a", weight=3.0)
    ls.register_tenant("b", weight=1.0)
    fuzz(ls, rg, seed, steps=50, tenants=("a", "b"))
    assert reg.engine_stats().twopc_messages == 0
    assert cen.conservation()["submitted"] > 0
