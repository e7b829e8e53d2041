"""BCPM device placement — the paper's technique as the framework's
placement engine.

Port of ``repro/launch/placement.py``.  The 2009 problem maps 1:1 onto
pod-scale device placement:

  resource graph  = pod topology, coarsened to *slices* (here: columns of
                    the v5e 16x16 ICI torus, 16 chips each; pods linked by
                    DCI).  Node capacity = aggregate TFLOP/s; link bandwidth
                    = aggregate ICI/DCI GB/s; link latency = hop latency.
  dataflow path   = the model's pipeline stages (layer groups) or a
                    multi-stage serving dataflow (ViT -> LM, encoder ->
                    decoder): C_req = TFLOP/s at the target step rate,
                    B_req = inter-stage activation GB/s.

The topology constants are the reference's (a v5e pod), so the port's plans
can be held against the reference's.  ``plan_pipeline`` / ``plan_serving``
build the BCPM instance from a ModelConfig and solve it through
``repro_torch.core.engine.solve``, by default with ``leastcost_torch``,
whose every superstep is the CUDA kernel ``batched_superstep.cu`` on a CUDA
device (``device=`` and ``kernel_impl=`` pass through; ``use_torch=False``
selects ``leastcost_python``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import engine
from ..core.dag import DataflowTree, treemap_leastcost
from ..core.graph import DataflowPath, Mapping, ResourceGraph
from ..core.problem import resolve_device
from ..models.config import ModelConfig, ShapeConfig

# v5e constants: the reference's instance (src/repro/launch/placement.py)
CHIP_TFLOPS = 197.0  # bf16
ICI_GBPS = 50.0  # per link
DCI_GBPS = 25.0  # inter-pod, per slice pairing (conservative)
ICI_HOP_US = 1.0
DCI_HOP_US = 10.0


@dataclasses.dataclass
class PodTopology:
    pods: int = 1
    rows: int = 16
    cols: int = 16
    chips_per_slice: int = 16  # one torus column

    @property
    def slices_per_pod(self) -> int:
        return self.rows * self.cols // self.chips_per_slice

    @property
    def n_slices(self) -> int:
        return self.pods * self.slices_per_pod


def slice_resource_graph(topo: PodTopology, *, utilization: float = 0.6) -> ResourceGraph:
    """Coarsened resource graph: one node per torus column (slice).

    Adjacent columns are linked by ``rows`` ICI links (torus: column ring);
    pod boundaries by DCI.  Capacity = usable TFLOP/s per slice.
    """
    n = topo.n_slices
    spp = topo.slices_per_pod
    cap = np.full(n, topo.chips_per_slice * CHIP_TFLOPS * utilization, np.float32)
    bw = np.zeros((n, n), np.float32)
    lat = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(lat, 0.0)
    col_bw = topo.rows * ICI_GBPS  # parallel links between adjacent columns
    for p in range(topo.pods):
        base = p * spp
        for i in range(spp):
            j = (i + 1) % spp  # torus ring over columns
            a, b = base + i, base + j
            bw[a, b] = bw[b, a] = col_bw
            lat[a, b] = lat[b, a] = ICI_HOP_US
    for p in range(topo.pods - 1):  # DCI chain between pods (edge slices)
        a = p * spp + spp - 1
        b = (p + 1) * spp
        bw[a, b] = bw[b, a] = topo.rows * DCI_GBPS
        lat[a, b] = lat[b, a] = DCI_HOP_US
    return ResourceGraph(cap, bw, lat)


@dataclasses.dataclass
class PlacementPlan:
    stage_slices: list  # slice id per pipeline stage
    route: tuple
    latency_us: float
    stage_tflops: list
    stage_bw_gbps: list
    mapping: Mapping


def _stage_flops(cfg: ModelConfig, tokens_per_step: float,
                 n_stages: Optional[int] = None,
                 slice_tflops: float = 16 * CHIP_TFLOPS * 0.6) -> tuple[list, list]:
    """Split the model into per-stage FLOPs + inter-stage activation bytes.

    ``n_stages=None`` auto-sizes stages so each fits one slice's capacity
    (the resource-graph nodes are slices; BCPM maps one stage per visit)."""
    if cfg.family == "encdec":
        n_total = cfg.param_count()
        enc_frac = cfg.n_enc_layers / (cfg.n_enc_layers + 2 * cfg.n_dec_layers)
        stages = [enc_frac, 1 - enc_frac]
        flops = [2 * f * n_total * tokens_per_step for f in stages]
        act = [tokens_per_step * cfg.d_model * 2]  # enc_out bytes/step
        return flops, act
    if cfg.family == "vlm":
        # stub frontend ~ 1/4 of backbone cost; backbone = LM
        lm_flops = 2 * cfg.active_param_count() * tokens_per_step
        flops = [0.25 * lm_flops, lm_flops]
        act = [tokens_per_step * cfg.d_model * 2]
        return flops, act
    total = 2 * cfg.active_param_count() * tokens_per_step
    if n_stages is None:
        n_stages = max(2, int(np.ceil(total / 1e12 / slice_tflops * 1.1)))
        n_stages = min(n_stages, max(cfg.n_layers, 2))
    per = total / n_stages
    act = [tokens_per_step * cfg.d_model * 2] * (n_stages - 1)
    return [per] * n_stages, act


def plan_pipeline(
    cfg: ModelConfig,
    shape: ShapeConfig,
    topo: PodTopology = PodTopology(),
    *,
    steps_per_sec: float = 1.0,
    src_slice: int = 0,
    dst_slice: Optional[int] = None,
    use_torch: bool = True,
    method: Optional[str] = None,
    device=None,
    kernel_impl: Optional[str] = None,
) -> Optional[PlacementPlan]:
    """Place the model's pipeline stages onto pod slices via BCPM.

    Solved through the unified mapper engine (``core.engine.solve``);
    ``method`` picks any registered backend, defaulting to the tensorized
    DP ``leastcost_torch`` (``use_torch=False`` keeps the legacy
    path-carrying ``leastcost_python``).  ``leastcost_torch`` runs on
    ``device`` (CUDA unless the caller asks for the CPU); ``kernel_impl``
    goes to the backend.
    train: backward ~ 2x forward -> 3x forward FLOPs per step.
    """
    method = method or ("leastcost_torch" if use_torch else "leastcost_python")
    solve_cfg = {} if kernel_impl is None else {"kernel_impl": kernel_impl}
    if method in engine.BATCHED_METHODS:
        solve_cfg["device"] = resolve_device(device)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 3.0 if shape.kind == "train" else 1.0
    flops, act_bytes = _stage_flops(cfg, tokens * steps_per_sec * mult)
    creq = [f / 1e12 for f in flops]  # TFLOP/s
    breq = [a / 1e9 for a in act_bytes]  # GB/s
    rg = slice_resource_graph(topo)
    # infeasible if more stages than slices or any stage exceeds a slice
    if len(creq) + 2 > rg.n * 4 or (creq and max(creq) > float(rg.cap.max())):
        return None
    dst = dst_slice if dst_slice is not None else topo.n_slices - 1
    # source/sink anchors with zero compute (data in / results out)
    df = DataflowPath(
        creq=np.asarray([0.0] + creq + [0.0], np.float32),
        breq=np.asarray([breq[0] if breq else 1.0] + breq + [breq[-1] if breq else 1.0],
                        np.float32),
        src=src_slice,
        dst=dst,
    )
    mapping, _stats = engine.solve(rg, df, method=method, **solve_cfg)
    if mapping is None:
        return None
    stage_slices = list(mapping.assign[1:-1])
    return PlacementPlan(
        stage_slices=stage_slices,
        route=mapping.route,
        latency_us=mapping.cost,
        stage_tflops=creq,
        stage_bw_gbps=breq,
        mapping=mapping,
    )


def plan_serving(cfg: ModelConfig, shape: ShapeConfig, topo: PodTopology = PodTopology(),
                 *, requests_per_sec: float = 10.0, **kw) -> Optional[PlacementPlan]:
    """Place a serving dataflow (frontend -> backbone -> sampler)."""
    return plan_pipeline(cfg, shape, topo,
                         steps_per_sec=requests_per_sec / max(shape.global_batch, 1),
                         **kw)


def plan_tree_serving(
    cfg: ModelConfig,
    topo: PodTopology = PodTopology(),
    *,
    branch_tflops: dict | None = None,
    branch_gbps: float = 1.0,
    src_slices: dict | None = None,
    dst_slice: int | None = None,
):
    """Place a multi-source serving dataflow (paper §4 tree extension).

    E.g. a VLM with separate vision and text frontends merging into the LM:

        vision ──┐
                 ├──> backbone ──> sink
        text  ───┘

    ``branch_tflops``: {"vision": x, "text": y, "backbone": z} TFLOP/s.
    Sources/sink pinned to slices.  Solved with core.dag.treemap_leastcost
    (numpy) on the pod slice graph.  The paper's Fig. 2 DAG (a source
    feeding two stages) reduces to this form by duplicating the pinned source — sound
    because pinned sources carry no compute requirement.
    """
    b = branch_tflops or {
        "vision": 0.25 * 2 * cfg.active_param_count() / 1e12,
        "text": 0.05 * 2 * cfg.active_param_count() / 1e12,
        "backbone": 2 * cfg.active_param_count() / 1e12,
    }
    # tree nodes: 0=vision-src, 1=text-src, 2=backbone, 3=sink
    creq = np.array([b["vision"], b["text"], b["backbone"], 0.0], np.float32)
    breq = np.array([branch_gbps, branch_gbps, branch_gbps, 0.0], np.float32)
    parent = np.array([2, 2, 3, -1])
    pin = dict(src_slices or {0: 0, 1: 1})
    pin[3] = topo.n_slices - 1 if dst_slice is None else dst_slice
    rg = slice_resource_graph(topo)
    tree = DataflowTree(creq=creq, parent=parent, breq=breq, pinned=pin)
    return treemap_leastcost(rg, tree)
