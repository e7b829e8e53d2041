"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/``
under the checkout, as ``<stem>_<hash>.so`` keyed on the source and the
flags, and loaded with ``ctypes``.  Every library exports
``<stem>_error_string(int)`` for the CUDA error code its launch function
returns.  :func:`build_all` starts one ``nvcc`` per missing library at once,
so a caller that needs several kernels pays for the slowest build only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

# src/repro_torch/kernels/_build.py -> checkout root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")  # -v: registers, shared memory, spills


@dataclasses.dataclass(frozen=True)
class Build:
    source: Path
    path: Path  # the shared library
    build_s: float  # nvcc wall time; 0.0 on a cache hit
    cache_hit: bool
    log: str = ""  # nvcc's output (ptxas resource usage); empty on a hit


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    build: Build


_BUILDS: dict[Path, Build] = {}  # first build record per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built (put the CUDA toolkit's bin/ on PATH)")


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{key}.so"


def build_all(sources) -> list[Build]:
    """Compile every source whose library is not cached, all ``nvcc``
    processes started together; raises if any build fails."""
    sources = [Path(s) for s in sources]
    todo = [s for s in sources
            if s not in _BUILDS and not library_path(s).exists()]
    for s in sources:
        if s not in _BUILDS and s not in todo:
            _BUILDS[s] = Build(s, library_path(s), 0.0, True)
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in todo:
            out = library_path(s)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            procs.append((s, out, tmp, time.perf_counter(), subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for s, out, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{s}:\n{log}")
                continue
            os.replace(tmp, out)
            _BUILDS[s] = Build(s, out, time.perf_counter() - t0, False, log)
        if failed:
            raise RuntimeError("\n".join(failed))
    return [_BUILDS[s] for s in sources]


def load(source: Path) -> KernelLibrary:
    """Build ``source`` if needed and load its library."""
    b = build_all([source])[0]
    lib = ctypes.CDLL(str(b.path))
    err = getattr(lib, f"{Path(source).stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return KernelLibrary(lib, b)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``; the kernels'
    launch plans size their grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_launch(lib: KernelLibrary, err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = getattr(lib.lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def check_tensor(name, x, dtype, shape, device) -> None:
    """The wrappers' argument check: dtype, shape, device, contiguity."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
