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
from repro_torch.core import engine, leastcost
from repro_torch.kernels.minplus import batched

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


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_reference(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    assert not re.search(r"^\s*(import|from)\s+repro(\.|\s)", src, re.M), path


def _tiny():
    rg = T.waxman(8, seed=1)
    return rg, T.random_dataflow(rg, 4, seed=2)


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rg, df = _tiny()
    calls = [
        lambda: T.OnlinePlacer(rg),
        lambda: engine.solve(rg, df),
        lambda: engine.solve_batch(rg, [df]),
        lambda: engine.solve_batch_dispatch(rg, [df]),
        lambda: leastcost.leastcost_torch(rg, df),
        lambda: leastcost.leastcost_torch_batched(rg, [df]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_explicit_cpu_runs_the_plain_path_and_cuda_impl_on_cpu_raises():
    rg, df = _tiny()
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
