"""Multi-pod dry run: build and count every (arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``.  For each cell this starts a ``fake``
process group of the production mesh's size (16 x 16 single-pod, or
2 x 16 x 16 multi-pod; ``REPRO_DRYRUN_SCALE`` sets another edge, as in the
reference: 4 in the tests), builds the ``DeviceMesh`` with the reference's
axis names and, under ``FakeTensorMode`` (no real weight is allocated),
the step of ``launch/steps.py::build_step`` with its production shardings,
the model (``empty_model`` + ``shard_model``) and cache (``init_cache``) or
train state, and the batch of ``input_specs``.  It runs the step once
under the cost model's counters (``launch/hlo_cost.py``) as this rank,
rank 0, and writes the reference's JSON fields, per device:

- ``timing.lower_s``: the build and the fake layout; ``compile_s``: the
  counted run (there is no compile);
- ``memory``: the reference's ``memory_analysis()`` fields.
  ``argument_bytes`` is the local bytes, on its ``in_shardings``, of
  every argument leaf the step reads (the token and ``pos`` included, as
  XLA's arguments; ``hlo_cost.Counters.read``): the compiled reference
  keeps only those (``jax.jit``'s ``keep_unused=False``), so a decode
  step drops the encoder's weights and a Mamba step ``pos``, and a
  prefill drops the SSM states it writes without reading;
  ``output_bytes`` and ``alias_bytes`` (the outputs that are arguments: the
  cache, the train state) from the returned tensors; ``temp_bytes`` the
  peak of live local storage the step allocates, and ``peak_bytes`` that
  plus the arguments;
- ``cost``: the loop-aware totals (``flops``, ``bytes_accessed`` =
  ``bytes_hbm``, ``transcendentals`` = the elements of exp/log/tanh/
  sigmoid/rsqrt/erf-class results), because XLA's count-loops-once figure
  has no counterpart here;
- ``loop_aware``: ``hlo_cost``'s report;
- ``collectives``: ``collective_profile``, each dispatched collective
  counted once (a microbatch loop's body once, as the reference counts
  each instruction of its program text once), with the 12 largest.

Train cells run one microbatch weighted by ``n_acc`` (``Counters.
weighted``; the step's ``loop`` hook), as XLA weights a scan body by its
trip count, and the update once.  ``benchmarks/roofline.py`` reads these
keys.  ``--save-hlo`` writes, in place of the program text the port does
not have, the counted operators by name (``<stem>.ops.json``: count,
FLOPs and bytes each).

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k \\
        --mesh single --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..configs import (LONG_CONTEXT_OK, get_config, train_accumulation,
                       train_mode)
from ..core.problem import resolve_device
from ..dist import sharding as shd
from ..models.config import SHAPES
from . import hlo_cost
from .mesh import _device_mesh, make_production_mesh
from .steps import build_step, init_cache, shard_model

_SCALE = int(os.environ.get("REPRO_DRYRUN_SCALE", "16"))  # mesh edge (tests: 4)


def collective_profile(counters: hlo_cost.Counters) -> dict:
    """Operand bytes per collective kind, each dispatched collective
    counted once, and the 12 largest (the reference's fields)."""
    prof = {k: dict(v) for k, v in counters.coll_once.items()}
    biggest = sorted(((nb, k, h) for _, nb, k, h in counters.top),
                     key=lambda r: -r[0])
    prof["top_ops"] = [{"bytes": b, "kind": k, "hlo": h}
                       for b, k, h in biggest[:12]]
    return prof


def _world(n: int):
    """A ``fake`` process group of ``n`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh(mesh_kind: str, device: torch.device):
    multi = mesh_kind == "multi"
    _world(_SCALE * _SCALE * (2 if multi else 1))
    if _SCALE == 16:
        return make_production_mesh(multi_pod=multi, device=device)
    # test scale: the same topology, a smaller edge
    if multi:
        return _device_mesh(device, (2, _SCALE, _SCALE),
                            ("pod", "data", "model"))
    return _device_mesh(device, (_SCALE, _SCALE), ("data", "model"))


def local_nbytes(t: torch.Tensor, sharding) -> int:
    """Bytes of this rank's shard of a tensor of ``t``'s shape and dtype on
    ``sharding`` (torch's chunk rule: rank 0 holds the largest)."""
    shape = list(t.shape)
    if isinstance(sharding, shd.NamedSharding):
        sizes = list(shd.mesh_shape(sharding.mesh).values())
        for p, n in zip(sharding.placements, sizes):
            if isinstance(p, Shard):
                shape[p.dim] = -(-shape[p.dim] // n)
    count = 1
    for s in shape:
        count *= s
    return count * t.dtype.itemsize


def _argument_bytes(abstract, shardings, actual, read) -> int:
    """Local bytes of the argument leaves (``abstract`` on ``shardings``)
    whose counterpart in ``actual``, the arguments the step ran on, it
    read (``read``)."""
    if isinstance(actual, torch.nn.Module):
        actual = dict(actual.named_parameters())
    if isinstance(abstract, torch.Tensor):
        return local_nbytes(abstract, shardings) if read(actual) else 0
    if isinstance(abstract, dict):
        return sum(_argument_bytes(abstract[k], shardings[k], actual[k], read)
                   for k in abstract)
    if hasattr(abstract, "__dataclass_fields__"):
        return sum(_argument_bytes(getattr(abstract, f), getattr(shardings, f),
                                   getattr(actual, f), read)
                   for f in abstract.__dataclass_fields__)
    return sum(_argument_bytes(a, s, t, read)
               for a, s, t in zip(abstract, shardings, actual))


def _fake_like(meta: torch.Tensor, device) -> torch.Tensor:
    return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def _train_state(built):
    """The train state on its shardings, zero local shards (no weight is
    drawn, as ``init_train_state`` would)."""
    shardings, abstract = built.in_shardings[0], built.abstract_args[0]

    def empty(meta, sh):
        return torch.distributed.tensor.zeros(
            meta.shape, dtype=meta.dtype, device_mesh=sh.mesh,
            placements=sh.placements)

    return type(abstract)(
        empty(abstract.step, shardings.step),
        *(shd.tree_map(empty, getattr(abstract, f), getattr(shardings, f))
          for f in ("params", "m", "v")))


def _arguments(cfg, shape, built, device):
    """The step's arguments, fake, on its shardings, in its call order."""
    kind = built.meta["kind"]
    if kind == "train":
        batch = {k: _fake_like(v, device)
                 for k, v in built.abstract_args[1].items()}
        return (_train_state(built), batch)
    from ..models.registry import empty_model

    model = shard_model(empty_model(cfg, device), built.in_shardings[0])
    cache = init_cache(built)
    if kind == "decode":
        token = _fake_like(built.abstract_args[2], device)
        # the whole cache is read under a mask, at any position; a tensor
        # argument, as the reference's (a literal: a fake tensor keeps its
        # value, which indexing a row by it reads)
        pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                           device=device)
        return (model, cache, token, pos)
    batch = {k: _fake_like(v, device)
             for k, v in built.abstract_args[2].items()}
    return (model, cache, batch)


def count_step(built, args) -> tuple:
    """Run the built step once on ``args`` under the counters: (its
    output, the counters).  A train step runs one microbatch weighted by
    its ``n_acc``."""
    with hlo_cost.Counters() as c:
        c.arguments(args)
        kw = {}
        if built.meta["kind"] == "train" and built.meta["n_acc"] > 1:
            def loop(n):
                with c.weighted(n):
                    yield 0
            kw["loop"] = loop
        out = built.fn(*args, **kw)
        c.outputs(out)
    return out, c


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, save_hlo: bool = False, device=None, cfg=None,
             fsdp=None) -> dict:
    """Count one cell and write its JSON.  ``cfg`` (default: ``arch``'s
    production config) runs a cut of the model on the cell's mesh, shape,
    ``n_acc`` and mode; ``fsdp`` sets a train step's ZeRO-3 choice (None:
    the step's own rule on ``cfg``'s parameter count), which a cut of a
    model that needs it keeps."""
    t0 = time.time()
    dev = resolve_device(device)
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        raise SystemExit(f"{arch} x long_500k is a documented skip (DESIGN.md §6)")
    mesh = _mesh(mesh_kind, dev)
    kw = {}
    if shape.kind == "train":
        kw["n_acc"] = train_accumulation(arch)
        kw["mode"] = train_mode(arch)
        kw["fsdp"] = fsdp
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        built = build_step(cfg, shape, mesh, **kw)
        args = _arguments(cfg, shape, built, dev)
        t_lower = time.time() - t0
        out, c = count_step(built, args)
        t_compile = time.time() - t0 - t_lower
        mem = c.memory()
        mem["argument_bytes"] = _argument_bytes(
            built.abstract_args, built.in_shardings, args, c.read)
    del out, args
    loop_aware = c.report()
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "chips": int(mesh.size()),
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "n_acc": built.meta.get("n_acc", 1),
        "mode": kw.get("mode", "tp"),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "timing": {"lower_s": t_lower, "compile_s": t_compile},
        "memory": mem,
        "cost": {
            "flops": loop_aware["flops"],
            "bytes_accessed": loop_aware["bytes_hbm"],
            "transcendentals": c.transcendentals,
        },
        # the per-device profile (launch/hlo_cost.py), loop-aware by
        # construction: every trip is dispatched (or weighted)
        "loop_aware": loop_aware,
        "collectives": collective_profile(c),
    }
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{arch.replace('/', '_')}__{shape_name}__{mesh_kind}"
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    if save_hlo:
        with open(os.path.join(out_dir, stem + ".ops.json"), "w") as f:
            json.dump({k: {"count": n, "flops": fl, "bytes": b}
                       for k, (n, fl, b) in sorted(c.by_op.items())},
                      f, indent=1)
    print(f"[dryrun] {stem}: compile={t_compile:.1f}s "
          f"flops={result['cost']['flops']:.3e} "
          f"mem(arg={mem['argument_bytes']}, temp={mem['temp_bytes']})")
    print("memory_analysis:", mem)
    print("cost_analysis keys:", result["cost"])
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the fake tensors' device")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model's depth to this many layers (its "
                         "widths stay the published ones)")
    args = ap.parse_args(argv)
    cfg = (None if args.n_layers is None
           else get_config(args.arch).with_(n_layers=args.n_layers))
    run_cell(args.arch, args.shape, args.mesh, args.out,
             save_hlo=args.save_hlo, device=args.device, cfg=cfg)


if __name__ == "__main__":
    main()
