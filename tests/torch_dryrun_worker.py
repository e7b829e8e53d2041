"""Run one of the port's dry-run cells on a cut of its model.

    python tests/torch_dryrun_worker.py ARCH SHAPE MESH CUT OUT

Counts ``ARCH`` x ``SHAPE`` on the ``MESH`` ("single" or "multi") mesh of
``launch/dryrun.py`` (``REPRO_DRYRUN_SCALE`` sets its edge), with the
arch's production ``n_acc`` and train mode, on the arch's SMOKE config
changed by ``CUT`` (a JSON object of ``ModelConfig.with_`` fields, ``{}``
for SMOKE itself; its ``fsdp``, if present, is the train step's ZeRO-3
choice, which the production config makes by its size), with fake ``cpu``
tensors.  The cell's JSON goes to
``OUT/ARCH__SHAPE__MESH.json``, its counted operators to
``OUT/ARCH__SHAPE__MESH.ops.json``.  Imports no JAX.
"""
import json
import sys

from repro_torch.configs import get_config
from repro_torch.launch import dryrun


def main():
    arch, shape, mesh, cut, out = sys.argv[1:6]
    cut = json.loads(cut)
    fsdp = cut.pop("fsdp", None)
    cfg = get_config(arch, smoke=True).with_(**cut)
    dryrun.run_cell(arch, shape, mesh, out, device="cpu", cfg=cfg, fsdp=fsdp,
                    save_hlo=True)


if __name__ == "__main__":
    main()
