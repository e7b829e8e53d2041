"""Which layouts each dense product of a dry-run cell meets, per device.

    PYTHONPATH=src python tools/mm_layouts.py ARCH SHAPE [MESH] [CUT]

Counts ``ARCH`` x ``SHAPE`` on the ``MESH`` mesh ("single" by default;
``REPRO_DRYRUN_SCALE`` sets its edge) with fake CPU tensors, as
``launch/dryrun.py`` does, and prints, for every ``aten.mm`` the step
dispatches on DTensors, the placements and global shapes of its two
operands (mesh order; ``S0`` Shard(0), ``R`` Replicate, ``P`` Partial
sum) and the local product that DTensor runs for them, with its count
(weighted by the microbatches it stands for) and its FLOPs per device,
largest first.  ``CUT`` is a JSON object of ``ModelConfig.with_`` fields
(``published: true`` and ``seq_len``/``global_batch`` as in
``tests/torch_dryrun_worker.py``); without it the production config.  A
product whose local shape holds a whole dimension that its weight's
layout splits is a product every rank runs whole.
"""
import collections
import dataclasses
import json
import sys

from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.models.config import SHAPES


def _placement(p) -> str:
    if isinstance(p, Shard):
        return f"S{p.dim}"
    return "P" if isinstance(p, Partial) else "R"


def _layout(t) -> str:
    return ("(" + ",".join(_placement(p) for p in t.placements) + ")"
            + "x".join(str(n) for n in t.shape))


def main():
    arch, shape = sys.argv[1:3]
    mesh = sys.argv[3] if len(sys.argv) > 3 else "single"
    cut = json.loads(sys.argv[4]) if len(sys.argv) > 4 else None
    cfg = None
    if cut is not None:
        published = cut.pop("published", False)
        sizes = {k: cut.pop(k) for k in ("seq_len", "global_batch")
                 if k in cut}
        cfg = get_config(arch, smoke=not published).with_(**cut)
        SHAPES[shape] = dataclasses.replace(SHAPES[shape], **sizes)

    rows = collections.Counter()
    pending = [None]
    dispatch, count = (hlo_cost.Counters.__torch_dispatch__,
                       hlo_cost.Counters._count)

    def on_dtensor(self, func, types, args=(), kwargs=None):
        if (not self.paused and str(func).startswith("aten.mm")
                and any(issubclass(t, DTensor) for t in types)):
            pending[0] = tuple(_layout(a) for a in args[:2])
        return dispatch(self, func, types, args, kwargs)

    def on_local(self, func, args, kwargs, out):
        if str(func).startswith("aten.mm"):
            a, b = args[0].shape, args[1].shape
            rows[(pending[0], tuple(a), tuple(b))] += self.weight
            pending[0] = None
        return count(self, func, args, kwargs, out)

    hlo_cost.Counters.__torch_dispatch__ = on_dtensor
    hlo_cost.Counters._count = on_local
    res = dryrun.run_cell(arch, shape, mesh, "build/mm_layouts",
                          device="cpu", cfg=cfg)
    total = 0.0
    out = []
    for (dt, a, b), n in rows.items():
        flops = 2.0 * a[0] * a[1] * b[1] * n
        total += flops
        out.append((flops, n, dt, a, b))
    print(f"{arch} x {shape} x {mesh}: FLOPs per device "
          f"{res['loop_aware']['flops']:.6e}, aten.mm {total:.6e}")
    for flops, n, dt, a, b in sorted(out, key=lambda r: -r[0]):
        ops = " @ ".join(dt) if dt else "plain"
        print(f"{flops:.4e}  x{n:<5g} {ops}  ->  local "
              f"{a[0]}x{a[1]} @ {b[0]}x{b[1]}")


if __name__ == "__main__":
    main()
