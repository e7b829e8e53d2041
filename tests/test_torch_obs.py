"""The port's telemetry plane (``repro_torch.obs``) against the reference:
the metrics registry and histograms under the same records and merges,
and a traced regional plane whose spanning request crosses three regions.
After the same script the registry snapshots agree (``timing.*`` left out),
and the Chrome traces hold the same events (names, phases, categories,
tracks, flow ids and arguments; timestamps and durations are wall clock),
validate, and reconstruct the same request lifecycle."""
import numpy as np

import repro.core as R
import repro.obs as RO
import repro.service as RS
import repro_torch.obs as TO
import repro_torch.service as TS

from torch_parity import port_graph
from torch_planes import PORT_CFG, REF_CFG, Lockstep, canon, registry_snapshot


def _record(obs):
    reg = obs.MetricsRegistry()
    reg.inc("a.count", 2.0, plane="r0")
    reg.inc("a.count", 1.5, plane="r0")
    reg.gauge("a.depth", 7.0, tenant="x", klass="1")
    for v in (0.0, 0.3, 1.0, 3.0, 17.0, 1e6):
        reg.observe("a.rounds", v, n=2, mode="cold")
    child = obs.MetricsRegistry()
    child.inc("a.count", 4.0, plane="r1")
    child.observe("a.rounds", 5.0, mode="warm")
    reg.merge(child, plane="g0")
    obs.absorb_gossip_stats(reg, {"rounds": 3, "messages_sent": 12,
                                  "messages_per_round": 4.0})
    obs.absorb_span_stats(reg, {"attempts": 5, "max_chain": 3})
    obs.absorb_timing(reg, {"solve_ms": 1.25})
    return reg


def test_registry_and_histograms_match_reference():
    a, b = _record(RO), _record(TO)
    assert a.snapshot() == b.snapshot()
    assert a.total("a.count") == b.total("a.count")
    assert canon(a.labeled("a.rounds")) == canon(b.labeled("a.rounds"))
    ha, hb = RO.Histogram(), TO.Histogram()
    for v in (0.25, 1.0, 2.0, 9.0):
        ha.observe(v)
        hb.observe(v)
    assert ha.buckets == hb.buckets and ha.to_dict() == hb.to_dict()


def _events(doc):
    return [canon({k: v for k, v in ev.items() if k not in ("ts", "dur")})
            for ev in doc["traceEvents"]]


def test_traced_regional_plane_matches_reference(tmp_path):
    rg, assign = R.region_line(3, 4, seed=9)
    ta, tb = RO.Tracer(), TO.Tracer()
    kw = dict(region_of=assign, seed=9, micro_batch=8, fanout=2)
    a = RS.ControlPlane(rg, tracer=ta, **REF_CFG, **kw)
    b = TS.ControlPlane(port_graph(rg), tracer=tb, **PORT_CFG, **kw)
    ls = Lockstep(a, b)
    ls.register_tenant("svc-a", weight=1.0)
    rng = np.random.default_rng(9)

    def mkdf(r1, r2, p):
        src = int(rng.choice(np.nonzero(assign == r1)[0]))
        dst = int(rng.choice(np.nonzero(assign == r2)[0]))
        creq = rng.uniform(0.02, 0.15, p).astype(np.float32)
        creq[0] = creq[-1] = 0.0
        breq = rng.uniform(0.5, 2.0, p - 1).astype(np.float32)
        return R.DataflowPath(creq, breq, src, dst)

    bg = [ls.submit("svc-a", mkdf(r, r, 3)) for r in range(3)]
    rid = ls.submit("svc-a", mkdf(0, 2, 5), klass=1)
    for _ in range(6):
        ls.pump()
        ls.check()
        if rid in b.active_ids():
            break
    assert rid in b.active_ids()
    for r in [rid] + bg:
        if r in a.active_ids():
            ls.release(r)
    ls.check()
    assert registry_snapshot(a) == registry_snapshot(b)

    da = RO.to_chrome_trace(ta)
    db = TO.write_chrome_trace(tb, str(tmp_path / "trace.json"))
    assert _events(da) == _events(db)
    assert TO.validate_chrome_trace(db) == []
    life = TO.reconstruct_request(db, rid)
    names = [e["name"] for e in life]
    assert names == [e["name"] for e in RO.reconstruct_request(da, rid)]
    assert names[0] == "submit" and names[-1] == "release"
    assert "2pc.commit" in names
    reserves = {e["args"]["region"] for e in life
                if e["name"] == "2pc.reserve" and "args" in e}
    assert len(reserves) >= 2
    assert (TO.text_timeline(tb, max_rows=12).count("\n")
            == RO.text_timeline(ta, max_rows=12).count("\n"))


def test_engine_stats_absorb_like_reference():
    rg, assign = R.region_line(2, 4, seed=1)
    a, b = (RS.ControlPlane(rg, region_of=assign, **REF_CFG),
            TS.ControlPlane(port_graph(rg), region_of=assign, **PORT_CFG))
    ls = Lockstep(a, b)
    ls.register_tenant("t")
    ls.submit("t", R.DataflowPath.make([0.0, 0.1, 0.0], [1.0, 1.0], 0,
                                       rg.n - 1))
    ls.pump()
    ra, rb = RO.MetricsRegistry(), TO.MetricsRegistry()
    RO.absorb_engine_stats(ra, a.engine_stats(), plane="top")
    TO.absorb_engine_stats(rb, b.engine_stats(), plane="top")

    def strip(reg):
        return {k.replace("=ref", "=plain")
                 .replace("=leastcost_jax", "=leastcost_torch"): v
                for k, v in reg.snapshot().items()
                if not k.startswith("timing.")}

    assert strip(ra) == strip(rb)
    assert any(k.startswith("engine.twopc_messages") for k in strip(rb))
