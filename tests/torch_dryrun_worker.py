"""Run one of the port's dry-run cells on a cut of its model.

    python tests/torch_dryrun_worker.py ARCH SHAPE MESH CUT OUT

Counts ``ARCH`` x ``SHAPE`` on the ``MESH`` ("single" or "multi") mesh of
``launch/dryrun.py`` (``REPRO_DRYRUN_SCALE`` sets its edge), with the
arch's production ``n_acc`` and train mode, on the arch's SMOKE config
changed by ``CUT`` (a JSON object of ``ModelConfig.with_`` fields, ``{}``
for SMOKE itself; its ``fsdp``, if present, is the train step's ZeRO-3
choice, which the production config makes by its size; ``published:
true`` starts from the production config instead of SMOKE; ``seq_len``
and ``global_batch`` cut the shape, in this process's ``SHAPES``), with
fake ``cpu`` tensors.  The cell's JSON goes to
``OUT/ARCH__SHAPE__MESH.json``, its counted operators to
``OUT/ARCH__SHAPE__MESH.ops.json``.  Imports no JAX.
"""
import dataclasses
import json
import sys

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES


def main():
    arch, shape, mesh, cut, out = sys.argv[1:6]
    cut = json.loads(cut)
    fsdp = cut.pop("fsdp", None)
    smoke = not cut.pop("published", False)
    sizes = {k: cut.pop(k) for k in ("seq_len", "global_batch") if k in cut}
    cfg = get_config(arch, smoke=smoke).with_(**cut)
    SHAPES[shape] = dataclasses.replace(SHAPES[shape], **sizes)
    dryrun.run_cell(arch, shape, mesh, out, device="cpu", cfg=cfg, fsdp=fsdp,
                    save_hlo=True)


if __name__ == "__main__":
    main()
