"""Run the port's cost model (``repro_torch.launch.hlo_cost``) on a ``fake``
process group and write what it counted.

    python tests/torch_cost_worker.py OUT

Starts a 256-rank ``fake`` process group (this process is rank 0), builds
a (16, 16) ("data", "model") ``DeviceMesh`` on the CPU and, under
``FakeTensorMode``, counts each case; ``OUT`` gets a JSON object {case
name: what it counted}.  Imports no JAX.  A case that raises records its
error instead.

Cases: ``sharded_mm`` (64, 128) @ (128, 256) with the left operand
``Shard(0)`` over ``data`` and the right ``Shard(1)`` over ``model``;
``replicated_mm``, the same on replicated operands; ``contraction``, the
contracted dimension sharded over ``model`` on both and the product made
Replicate; ``dtensor_view``, a view of a sharded DTensor;
``shard_to_shard``, a (64, 128) ``Shard(0)`` over ``model`` redistributed
to ``Shard(1)`` (on this CPU mesh DTensor runs it as an all-gather and a
chunk; a CUDA mesh as one all-to-all); ``n_acc``, a
train step of 2 microbatches counted in full and as one trip weighted by
2 (``launch/dryrun.py``).
"""
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch import hlo_cost

# a dense config whose heads, kv heads and widths all divide the model axis
NACC_CFG = dict(d_model=256, n_heads=16, n_kv_heads=16, d_ff=512,
                vocab=512, n_layers=1)


def mesh_cases(mesh):
    R, S = Replicate(), Shard

    def mm(pa, pb, then=None):
        A = distribute_tensor(torch.empty(64, 128), mesh, pa)
        B = distribute_tensor(torch.empty(128, 256), mesh, pb)

        def fn():
            y = A @ B
            return y if then is None else y.redistribute(mesh, then)
        return hlo_cost.analyze(fn)

    yield "sharded_mm", lambda: mm([S(0), R], [R, S(1)])
    yield "replicated_mm", lambda: mm([R, R], [R, R])
    yield "contraction", lambda: mm([R, S(1)], [R, S(0)], then=[R, R])

    def view():
        A = distribute_tensor(torch.empty(64, 128), mesh, [S(0), S(1)])
        return hlo_cost.analyze(lambda: A.view(64, 16, 8).transpose(1, 2))
    yield "dtensor_view", view

    def shard_to_shard():
        A = distribute_tensor(torch.empty(64, 128), mesh, [R, S(0)])
        return hlo_cost.analyze(lambda: A.redistribute(mesh, [R, S(1)]))
    yield "shard_to_shard", shard_to_shard


def n_acc_case(mesh):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.config import ShapeConfig

    cfg = get_config("llama3.2-1b", smoke=True).with_(**NACC_CFG)
    shape = ShapeConfig("t", "train", 32, 64)
    built = build_train_step(cfg, shape, mesh, n_acc=2, remat=False)
    args = dryrun._arguments(cfg, shape, built, torch.device("cpu"))
    with hlo_cost.Counters() as full:
        built.fn(*args)  # every microbatch
    _, one = dryrun.count_step(built, args)
    return {"n_acc": built.meta["n_acc"],
            **{name: dict(c.report(), transcendentals=c.transcendentals)
               for name, c in (("full", full), ("one_trip", one))}}


def main():
    out_path = sys.argv[1]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))
    cases = list(mesh_cases(mesh)) + [("n_acc", lambda: n_acc_case(mesh))]
    out = {}
    with FakeTensorMode():
        for name, fn in cases:
            t0 = time.perf_counter()
            try:
                out[name] = dict(fn(), seconds=time.perf_counter() - t0)
            except Exception:  # recorded; the test reports it
                out[name] = {"error": traceback.format_exc()}
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
