"""Device meshes, by the reference's names (``repro/launch/mesh.py``).

This slice trains on one device: ``make_local_mesh(1, 1)`` is a (data,
model) = (1, 1) mesh on an explicit device.  A larger mesh (DeviceMesh and
DTensor placements) is ROADMAP Queue 1 item 15 and raises
``NotImplementedError``; ``make_production_mesh`` first checks the device
count, as the reference's ``jax.make_mesh`` does, so on a machine without
256 devices it raises ``ValueError`` there too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.problem import resolve_device

SHARDED = "meshes over more than one device (DeviceMesh/DTensor) are " \
    "ROADMAP Queue 1 item 15, not ported yet"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh of one device."""
    device: torch.device
    shape: dict = dataclasses.field(
        default_factory=lambda: {"data": 1, "model": 1})


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's single-pod 16x16 (data, model) mesh, or 2 x 16 x 16
    (pod, data, model): 256 or 512 devices."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    need = 1
    for s in shape:
        need *= s
    have = _device_count(dev)
    if have < need:
        raise ValueError(f"Number of devices {have} must be >= the product "
                         f"of mesh_shape {shape}")
    raise NotImplementedError(SHARDED)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh on ``device`` (CUDA unless the caller asks for
    the CPU); only (1, 1) in this slice."""
    dev = resolve_device(device)
    if data * model > _device_count(dev):
        raise AssertionError(f"need {data * model} devices, have "
                             f"{_device_count(dev)}")
    if (data, model) != (1, 1):
        raise NotImplementedError(SHARDED)
    return Mesh(dev)
