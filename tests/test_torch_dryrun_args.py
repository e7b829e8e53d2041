"""The dry run's ``argument_bytes`` against the reference's
``argument_size_in_bytes``, on SMOKE configs at a (2, 2) mesh
(``REPRO_DRYRUN_SCALE=2``).

The compiled reference keeps only the argument leaves its program reads
(``jax.jit``'s ``keep_unused=False``), and the port counts only the leaves
its step reads (``hlo_cost.Counters.read``).  The cells: whisper-medium
``decode_32k`` (the decode step reads no encoder weight and no cross
``wk``/``wv``: the cross K/V come from the cache), falcon-mamba-7b
``decode_32k`` (a Mamba step reads no ``pos``), falcon-mamba-7b and
zamba2-7b ``prefill_32k`` (the prefill writes the SSM states without
reading them; the KV cache, written in part, is kept; zamba2 cut to 2
layers, one shared-attention call site, to keep the test short), and
llama3.2-1b ``train_4k``, which reads every leaf.  Each cell runs in a subprocess of
its own, the port's through ``tests/torch_dryrun_worker.py`` and the
reference's through ``tests/torch_dryrun_args_worker.py``, all started
together at module start."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EDGE = "2"
# name: (arch, shape, the cut of its SMOKE config)
CELLS = {"whisper-medium:decode_32k": ("whisper-medium", "decode_32k", {}),
         "falcon-mamba-7b:decode_32k": ("falcon-mamba-7b", "decode_32k", {}),
         "falcon-mamba-7b:prefill_32k": ("falcon-mamba-7b", "prefill_32k",
                                         {}),
         "zamba2-7b:prefill_32k": ("zamba2-7b", "prefill_32k",
                                   {"n_layers": 2}),
         "llama3.2-1b:train_4k": ("llama3.2-1b", "train_4k", {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_args")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_SCALE=EDGE, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    jobs = {"ref": [sys.executable,
                    str(ROOT / "tests" / "torch_dryrun_args_worker.py"), EDGE,
                    str(out / "ref.json"), json.dumps(CELLS)]}
    for cell, (arch, shape, cut) in CELLS.items():
        jobs[cell] = [sys.executable,
                      str(ROOT / "tests" / "torch_dryrun_worker.py"), arch,
                      shape, "single", json.dumps(cut), str(out / "port")]
    procs = {name: subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, cmd in jobs.items()}
    errors = {}
    for name, p in procs.items():
        _, stderr = p.communicate(timeout=900)
        if p.returncode:
            errors[name] = stderr[-3000:]
    assert "ref" not in errors, errors["ref"]
    return out, errors


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_bytes_equal_the_reference(runs, cell):
    out, errors = runs
    assert cell not in errors, errors.get(cell)
    arch, shape, _ = CELLS[cell]
    port = json.loads((out / "port" / f"{arch}__{shape}__single.json")
                      .read_text())
    ref = json.loads((out / "ref.json").read_text())[cell]
    assert port["memory"]["argument_bytes"] == ref
    assert port["memory"]["peak_bytes"] == (
        ref + port["memory"]["temp_bytes"])
