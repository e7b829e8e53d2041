"""The reference's ``argument_size_in_bytes`` of dry-run cells on SMOKE
configs.

    python tests/torch_dryrun_args_worker.py EDGE OUT CELLS

``CELLS`` is a JSON object {name: [ARCH, SHAPE, CUT]}.  For each cell
this builds the reference's step (``repro.launch.steps.build_step``) for
``ARCH``'s SMOKE config changed by ``CUT`` (``ModelConfig.with_`` fields)
on a (EDGE, EDGE) ("data", "model") mesh of forced host devices, with the
arch's production ``n_acc`` and train mode, lowers and compiles it on its
abstract arguments, as ``repro/launch/dryrun.py`` does, and writes
{name: argument_size_in_bytes} to ``OUT`` as JSON.
"""
import json
import os
import sys


def main():
    edge, out, cells = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={edge * edge}")
    from repro.configs import get_config, train_accumulation, train_mode
    from repro.launch.mesh import _mk
    from repro.launch.steps import build_step
    from repro.models.config import SHAPES

    mesh = _mk((edge, edge), ("data", "model"))
    found = {}
    for name, (arch, shape_name, cut) in cells.items():
        shape = SHAPES[shape_name]
        kw = {}
        if shape.kind == "train":
            kw = dict(n_acc=train_accumulation(arch), mode=train_mode(arch))
        with mesh:
            cfg = get_config(arch, smoke=True).with_(**cut)
            built = build_step(cfg, shape, mesh, **kw)
            compiled = built.fn.lower(*built.abstract_args).compile()
        found[name] = compiled.memory_analysis().argument_size_in_bytes
    with open(out, "w") as f:
        json.dump(found, f)


if __name__ == "__main__":
    main()
