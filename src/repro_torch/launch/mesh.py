"""Device meshes, by the reference's names (``repro/launch/mesh.py``).

A mesh over more than one device is a ``torch.distributed`` ``DeviceMesh``
with named dimensions, over the ranks of the default process group (which
the caller initializes: gloo on the CPU, NCCL on cards); the sharded train
and serving steps (``launch/steps.py``) lay their tensors out on it as
DTensors.  Without a process group, ``make_local_mesh(1, 1)`` is the
one-device :class:`Mesh` on which the steps run on plain tensors.
``make_production_mesh`` needs 256 or 512 ranks and raises ``ValueError``
below that, as the reference's ``jax.make_mesh`` does on a machine without
them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.problem import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a mesh, on one device: the one-device
    (data, model) = (1, 1) mesh the steps run on with plain tensors, or,
    with another ``shape``, a stand-in whose only use is ``Rules``'
    shapes (the reference's ``AbstractMesh``)."""
    device: torch.device
    shape: dict = dataclasses.field(
        default_factory=lambda: {"data": 1, "model": 1})


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_mesh(dev: torch.device, shape: tuple, names: tuple) -> DeviceMesh:
    need = 1
    for s in shape:
        need *= s
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's single-pod 16x16 (data, model) mesh, or 2 x 16 x 16
    (pod, data, model): 256 or 512 ranks of the default process group."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = _ranks()
    if have < need:
        raise ValueError(f"Number of devices {have} must be >= the product "
                         f"of mesh_shape {shape}")
    return _device_mesh(dev, shape, names)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) mesh over the first ``data * model`` ranks of the
    default process group, on CUDA unless the caller asks for the CPU; with
    no process group, (1, 1) is the one-device :class:`Mesh`."""
    dev = resolve_device(device)
    need, have = data * model, _ranks()
    if need > have:
        raise AssertionError(f"need {need} devices, have {have}")
    if not dist.is_initialized():
        return Mesh(dev)
    return _device_mesh(dev, (data, model), ("data", "model"))
