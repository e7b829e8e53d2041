"""Tree checkpoints: per-leaf .npy files, atomic commit, async save,
restore onto the current device.

Port of ``repro/ckpt/checkpoint.py``, with its on-disk layout::

    <dir>/step_000123.tmp/...   (write)
    <dir>/step_000123/          (atomic rename on completion)
        META.json               ({"step", "leaves": [{name, file, shape,
                                  dtype}]})
        leaf_00000.npy ...

A tree is nested dicts, lists, tuples and NamedTuples (a ``TrainState``)
of tensors; a leaf's name joins its path with ``/`` as the reference's
names do (a NamedTuple's field as ``.field``, a dict's key, a list's
index): a train state's leaves are ``.step``, ``.params/embed``,
``.m/blocks.0.attn.wq`` and so on.  ``save`` copies every leaf to
host memory before it returns, then writes from a thread if asked: the
port's train step updates the state in place, so the copy must not wait
for the thread.  A tree of DTensors (a sharded train state) is gathered
whole on every rank of its mesh (``full_tensor()``, a collective); the
mesh's rank 0 writes it, and the other ranks wait until it has (the write
is then never in a thread).  ``restore`` loads into the structure of a
template and, given a tree of the same structure of ``torch.device``s or
of ``dist.sharding.NamedSharding``s, puts each leaf on its device or
lays it out on its mesh: the reference's elastic restore onto another
mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..dist import sharding as shd

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Tree, path=()):
    """(path, leaf) pairs in order: dicts by their keys' order, sequences
    and NamedTuples by position."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), path + ("." + k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _unflatten(template: Tree, leaves):
    """``template``'s structure with its leaves taken from ``leaves`` (an
    iterator) in ``_flatten``'s order."""
    if isinstance(template, dict):
        return type(template)((k, _unflatten(v, leaves))
                              for k, v in template.items())
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, k), leaves)
                                for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A host copy that later in-place updates of ``leaf`` do not reach;
    a DTensor whole (a collective over its mesh)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: checkpoint a float32 "
                            "state")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(directory: str, step: int, tree: Tree, *, blocking: bool = True):
    """Atomic checkpoint write. Returns the thread when ``blocking=False``
    (a tree of DTensors is written before this returns, by its mesh's rank
    0 alone)."""
    flat = [("/".join(p), _to_host(x)) for p, x in _flatten(tree)]
    mesh = next((x.device_mesh for _, x in _flatten(tree)
                 if isinstance(x, DTensor)), None)

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        meta = {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(flat):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), leaf)
            meta["leaves"].append(
                {"name": name, "file": fn, "shape": list(leaf.shape),
                 "dtype": str(leaf.dtype)}
            )
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if mesh is not None:
        if shd.is_mesh_rank0(mesh):
            _write()
        shd.mesh_barrier(mesh)
        return None
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1))
        for m in (re.fullmatch(r"step_(\d+)", d) for d in os.listdir(directory))
        if m
    )


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, template: Tree, *, step: Optional[int] = None,
            sharding_tree: Optional[Tree] = None) -> tuple[Tree, int]:
    """Load into the structure of ``template``: CPU tensors, or each put on
    its leaf of ``sharding_tree`` (a tree of the same structure of
    ``torch.device``s or ``NamedSharding``s: DTensors on a ``DeviceMesh``,
    which may differ from the mesh that saved the tree).  Returns (tree,
    step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "META.json")) as f:
        meta = json.load(f)
    n = sum(1 for _ in _flatten(template))
    if n != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, template {n}"
        )
    where = (None if sharding_tree is None
             else [d for _, d in _flatten(sharding_tree)])
    leaves = []
    for i, e in enumerate(meta["leaves"]):
        t = torch.from_numpy(np.load(os.path.join(path, e["file"])))
        leaves.append(t if where is None else shd.put(t, where[i]))
    return _unflatten(template, iter(leaves)), step


def prune(directory: str, keep: int = 3):
    """Retain only the newest ``keep`` checkpoints."""
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
