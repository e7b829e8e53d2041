"""Parity of the port's device placement (``repro_torch.launch.placement``)
with the JAX reference on the CPU: the same slice graphs, and for every
architecture, shape cell and pod count the same plans bit for bit
(feasibility, ``stage_slices``, ``route``, ``latency_us`` and the stage
requirements), through the tensorized DP (``use_torch`` / ``use_jax``) and
through ``leastcost_python``."""
import numpy as np
import pytest

import repro.configs as RC
from repro.launch import placement as R
from repro.models.config import SHAPES as R_SHAPES

import repro_torch.configs as TC
from repro_torch.core import validate_mapping
from repro_torch.core.graph import DataflowPath
from repro_torch.launch import placement as T
from repro_torch.models.config import SHAPES

FIELDS = ("stage_slices", "route", "latency_us", "stage_tflops",
          "stage_bw_gbps")


def assert_same_plan(ref, port, what):
    assert (ref is None) == (port is None), what
    if ref is None:
        return
    for f in FIELDS:
        assert getattr(ref, f) == getattr(port, f), (what, f)
    assert ref.mapping.assign == port.mapping.assign, what
    assert ref.mapping.cost == port.mapping.cost, what


@pytest.mark.parametrize("pods", [1, 2, 4])
def test_slice_graph_equal(pods):
    ref = R.slice_resource_graph(R.PodTopology(pods=pods))
    port = T.slice_resource_graph(T.PodTopology(pods=pods))
    for k in ("cap", "bw", "lat"):
        np.testing.assert_array_equal(getattr(ref, k), getattr(port, k))
    assert T.PodTopology(pods=pods).n_slices == port.n == 16 * pods


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_plan_pipeline_and_serving_equal(arch, pods):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    rtopo, ttopo = R.PodTopology(pods=pods), T.PodTopology(pods=pods)
    for shape in SHAPES:
        for fast in (True, False):
            what = (arch, shape, pods, fast)
            ref = R.plan_pipeline(rcfg, R_SHAPES[shape], rtopo, use_jax=fast)
            port = T.plan_pipeline(tcfg, SHAPES[shape], ttopo, use_torch=fast,
                                   device="cpu")
            assert_same_plan(ref, port, what)
        ref = R.plan_serving(rcfg, R_SHAPES[shape], rtopo,
                             requests_per_sec=100.0)
        port = T.plan_serving(tcfg, SHAPES[shape], ttopo,
                              requests_per_sec=100.0, device="cpu")
        assert_same_plan(ref, port, (arch, shape, pods, "serving"))


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-medium"])
def test_plan_tree_serving_equal(arch):
    for pods in (1, 2):
        ref = R.plan_tree_serving(RC.get_config(arch), R.PodTopology(pods=pods))
        port = T.plan_tree_serving(TC.get_config(arch),
                                   T.PodTopology(pods=pods))
        for f in ("assign", "cost", "valid", "routes"):
            assert getattr(ref, f) == getattr(port, f), (arch, pods, f)


# -- the reference's own placement tests (tests/test_placement.py) -------


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "llama3.2-1b",
                                  "deepseek-moe-16b"])
def test_pipeline_plan_feasible_and_valid(arch):
    plan = T.plan_pipeline(TC.get_config(arch), SHAPES["train_4k"],
                           T.PodTopology(pods=2), steps_per_sec=0.05,
                           dst_slice=31, device="cpu")
    assert plan is not None, arch
    rg = T.slice_resource_graph(T.PodTopology(pods=2))
    df = DataflowPath(
        np.asarray([0.0] + plan.stage_tflops + [0.0], np.float32),
        np.asarray([plan.stage_bw_gbps[0]] + plan.stage_bw_gbps
                   + [plan.stage_bw_gbps[-1]], np.float32),
        plan.mapping.assign[0], plan.mapping.assign[-1])
    ok, why = validate_mapping(rg, df, plan.mapping)
    assert ok, (arch, why)
    assert len(set(plan.route)) == len(plan.route)
    ref = R.plan_pipeline(RC.get_config(arch), R_SHAPES["train_4k"],
                          R.PodTopology(pods=2), steps_per_sec=0.05,
                          dst_slice=31)
    assert_same_plan(ref, plan, arch)


def test_serving_colocates_when_cheap_and_infeasible_rate():
    plan = T.plan_serving(TC.get_config("internvl2-2b"), SHAPES["prefill_32k"],
                          requests_per_sec=2, device="cpu")
    assert plan is not None and len(set(plan.stage_slices)) <= 2
    assert T.plan_pipeline(TC.get_config("qwen2.5-14b"), SHAPES["train_4k"],
                           T.PodTopology(pods=1), steps_per_sec=1e6,
                           device="cpu") is None


def test_kernel_impl_and_method_pass_through():
    cfg, shape = TC.get_config("qwen2-0.5b"), SHAPES["decode_32k"]
    plain = T.plan_serving(cfg, shape, device="cpu", kernel_impl="plain")
    assert plain.stage_slices == T.plan_serving(cfg, shape,
                                                device="cpu").stage_slices
    with pytest.raises(ValueError, match="CUDA device"):
        T.plan_serving(cfg, shape, device="cpu", kernel_impl="cuda")
    exact = T.plan_pipeline(cfg, shape, method="exact")
    assert exact.latency_us == plain.latency_us
