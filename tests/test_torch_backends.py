"""The port's numpy backends (exact PathMap, the asynchronous simulator
under all four §3.4 policies, annealed and RandomNeighbor LeastCostMap)
through ``engine.solve`` against the reference's engine: mapping and
unified ``Stats``, exactly."""
import pytest

import repro.core as R
import repro_torch.core as T

from torch_parity import port_df, port_graph, same_mapping

METHODS = [
    ("exact", {}),
    ("simulate", {"policy": "exact"}),
    ("simulate", {"policy": "leastcost"}),
    ("simulate", {"policy": "annealed", "seed": 3}),
    ("simulate", {"policy": "random_k", "k": 2, "seed": 5}),
    ("anneal", {"seed": 1}),
    ("random_k", {"k": 2, "seed": 4}),
]
FIELDS = ("rounds", "messages_sent", "messages_processed", "messages_pruned",
          "messages_cross_device", "max_set_size", "maps_generated",
          "fallback_used", "validated", "virtual_time")


def instances():
    yield "paper", *R.paper_example()
    for seed in (0, 2, 3):  # feasible, with hundreds of messages
        rg = R.waxman(16, seed=seed)
        yield f"waxman16_{seed}", rg, R.random_dataflow(
            rg, 5, seed=seed + 7, creq_range=(0.02, 0.5),
            breq_range=(0.5, 5.0))


INSTANCES = list(instances())


@pytest.mark.parametrize("method,cfg", METHODS,
                         ids=[f"{m}-{c.get('policy', '')}" for m, c in METHODS])
@pytest.mark.parametrize("name,rg,df", INSTANCES,
                         ids=[i[0] for i in INSTANCES])
def test_backend_matches_reference(method, cfg, name, rg, df):
    m_ref, st_ref = R.solve(rg, df, method=method, **cfg)
    m, st = T.solve(port_graph(rg), port_df(df), method=method, **cfg)
    assert same_mapping(m_ref, m)
    assert name == "paper" or m is not None
    for f in FIELDS:
        assert getattr(st, f) == getattr(st_ref, f), f
    assert st.method == method and st.solve_n == rg.n


def test_registry_covers_the_reference_backends_ported_so_far():
    assert set(T.backends()) == {"exact", "simulate", "leastcost_python",
                                 "anneal", "random_k", "leastcost_torch",
                                 "shard_map"}
    assert set(T.backends()) - {"leastcost_torch"} <= set(R.backends())
