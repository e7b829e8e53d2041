"""The port stands alone: it imports no JAX and nothing of ``repro``, and
its entry points run on a CUDA device unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.service as TS
from repro_torch.configs import get_config
from repro_torch.core import engine, leastcost
from repro_torch.kernels.minplus import batched
from repro_torch.launch import mesh, placement, train
from repro_torch.models import SHAPES, init_model
from repro_torch.serving import Engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'repro' or k.startswith('repro.')\n"
        "               for k in sys.modules), 'imported the JAX package'\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("module", ["repro_torch.service", "repro_torch.obs",
                                    "repro_torch.core.dag",
                                    "repro_torch.configs",
                                    "repro_torch.models",
                                    "repro_torch.models.carry",
                                    "repro_torch.models.moe",
                                    "repro_torch.models.ssm",
                                    "repro_torch.models.encdec",
                                    "repro_torch.launch.placement",
                                    "repro_torch.launch.serve",
                                    "repro_torch.serving",
                                    "repro_torch.optim",
                                    "repro_torch.optim.adamw",
                                    "repro_torch.optim.compress",
                                    "repro_torch.data",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.ckpt",
                                    "repro_torch.ckpt.checkpoint",
                                    "repro_torch.runtime",
                                    "repro_torch.runtime.trainer",
                                    "repro_torch.launch.steps",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.dist",
                                    "repro_torch.dist.sharding",
                                    "repro_torch.launch.hlo_cost",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.dryrun_all",
                                    "repro_torch.kernels.minplus.ref",
                                    "repro_torch.kernels.place.ref"])
def test_service_obs_and_dag_import_without_jax(module):
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"m = importlib.import_module({module!r})\n"
        "assert not any(k == 'repro' or k.startswith('repro.')\n"
        "               for k in sys.modules), 'imported the JAX package'\n"
        "assert not any(k == 'jax' or k.startswith('jax.')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print(m.__name__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_reference(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    assert not re.search(r"^\s*(import|from)\s+repro(\.|\s)", src, re.M), path
    # nor by name, through importlib or __import__
    assert not re.search(r"""(import_module|__import__)\(\s*["'](repro|jax)\b""",
                         src), path


def _tiny():
    rg = T.waxman(8, seed=1)
    return rg, T.random_dataflow(rg, 4, seed=2)


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rg, df = _tiny()
    qwen, smoke = get_config("qwen2-0.5b"), get_config("qwen2-0.5b", smoke=True)
    calls = [
        lambda: T.OnlinePlacer(rg),
        lambda: engine.solve(rg, df),
        lambda: engine.solve(rg, df, method="shard_map"),
        lambda: engine.solve_batch(rg, [df]),
        lambda: engine.solve_batch_dispatch(rg, [df]),
        lambda: leastcost.leastcost_torch(rg, df),
        lambda: leastcost.leastcost_torch_batched(rg, [df]),
        lambda: TS.ControlPlane(rg),
        lambda: TS.ControlPlane(rg, regions=2),
        lambda: TS.ControlPlane(rg, levels=2, regions=4),
        lambda: placement.plan_pipeline(qwen, SHAPES["train_4k"]),
        lambda: placement.plan_serving(qwen, SHAPES["decode_32k"]),
        lambda: init_model(smoke, torch.Generator()),
        lambda: Engine(smoke, init_model(smoke, torch.Generator(),
                                         device="cpu")),
        lambda: mesh.make_local_mesh(1, 1),
        lambda: mesh.make_local_mesh(2, 2),
        lambda: mesh.make_production_mesh(),
        lambda: train.main(["--arch", "llama3.2-1b", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_explicit_cpu_runs_the_plain_path_and_cuda_impl_on_cpu_raises():
    rg, df = _tiny()
    _, st = engine.solve(rg, df, method="shard_map", device="cpu")
    assert st.kernel_impl == "plain" and st.rounds > 0
    m, st = leastcost.leastcost_torch(rg, df, device="cpu")
    assert st.kernel_impl == "plain" and st.rounds > 0
    with pytest.raises(ValueError, match="CUDA device"):
        leastcost.leastcost_torch(rg, df, device="cpu", kernel_impl="cuda")
    with pytest.raises(ValueError, match="kernel_impl"):
        leastcost.leastcost_torch(rg, df, device="cpu", kernel_impl="ref")


def test_wrapper_uses_plain_version_for_cpu_tensors_and_counts_no_launch():
    rng = np.random.default_rng(0)
    B, n, K = 2, 6, 4
    C = torch.from_numpy(rng.random((B, n, K)).astype(np.float32))
    pv = torch.full((B, n, K), -1, dtype=torch.int32)
    lat = torch.from_numpy((rng.random((n, n)) + 0.1).astype(np.float32))
    bw = torch.from_numpy((rng.random((n, n)) * 10).astype(np.float32))
    cap = torch.from_numpy((rng.random(n) * 3).astype(np.float32))
    prefix = torch.from_numpy(np.cumsum(rng.random((B, K)), 1).astype(np.float32))
    breq_k = torch.from_numpy((rng.random((B, K)) * 5).astype(np.float32))
    before = batched.LAUNCHES
    out = batched.batched_superstep(C, pv, pv, lat, bw, cap, prefix, breq_k)
    ref = batched.batched_superstep_plain(C, pv, pv, lat, bw, cap, prefix,
                                          breq_k)
    assert batched.LAUNCHES == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
