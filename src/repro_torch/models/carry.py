"""Carrying weights across from the JAX package.

The reference keeps a model's parameters as a pytree of arrays with the
layers stacked: ``tree["blocks"]["attn"]["wq"]`` is (L, d, nq * hd).  The
port's ``LM`` names the same array of layer ``l`` ``blocks.{l}.attn.wq``;
DeepSeekMoE's ``dense_blocks`` and the enc-dec's ``enc_blocks`` and
``dec_blocks`` stack the same way, an MoE layer's expert weights
``tree["blocks"]["moe"]["wi"]`` (L, E, d, f) become ``blocks.{l}.moe.wi``
(E, d, f), and an SSM layer's ``tree["blocks"]["ssm"]["A_log"]`` becomes
``blocks.{l}.ssm.A_log``.  The hybrid's ``shared_attn`` is one block, not
stacked: ``shared_attn.attn.wq``.
Both sides cross as numpy arrays, so nothing here imports the JAX package:

- :func:`params_from_reference` builds the port's model from the
  reference's parameter pytree (``jax.tree.map(np.asarray, params)``);
- :func:`params_to_numpy` is its inverse.

A model of either package carried from the same arrays computes the same
function, up to the rounding of each package's kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.problem import resolve_device
from .config import ModelConfig
from .encdec import EncDec
from .transformer import LM

# the reference's layer-stacked subtrees
STACKED = ("dense_blocks", "blocks", "enc_blocks", "dec_blocks")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_reference(cfg: ModelConfig, tree: dict, *, device=None):
    """The port's model (an ``EncDec`` for the enc-dec family, else an
    ``LM``) holding the reference's parameters ``tree`` (numpy arrays;
    bfloat16 ones as JAX hands them to numpy), cast to the dtype of the
    port's parameter (``cfg.dtype``; the MoE router and the SSMs' ``A_log``
    and ``D`` float32), on ``device``."""
    dev = resolve_device(device)
    model = (EncDec if cfg.family == "encdec" else LM)(cfg, device=dev)
    params = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for path, arr in _leaves(tree):
            t = _to_torch(arr)
            if path[0] in STACKED:
                names = [".".join((path[0], str(i)) + path[1:])
                         for i in range(t.shape[0])]
                parts = list(t)
            else:
                names, parts = [".".join(path)], [t]
            for name, part in zip(names, parts):
                if name not in params:
                    raise KeyError(f"the port's model has no {name}")
                p = params[name]
                if tuple(part.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: {tuple(part.shape)} into "
                                     f"{tuple(p.shape)}")
                p.copy_(part)
                filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"the reference's tree lacks {missing}")
    return model


def params_to_numpy(model) -> dict:
    """The reference's pytree layout (layers stacked) as float32 numpy
    arrays; a bfloat16 model's values widen exactly."""
    tree: dict = {}
    stacked: dict[tuple, list] = {}
    for name, p in model.named_parameters():
        a = p.detach().to(device="cpu", dtype=torch.float32).numpy()
        parts = name.split(".")
        if parts[0] in STACKED:
            stacked.setdefault((parts[0],) + tuple(parts[2:]), []).append(a)
            continue
        _put(tree, tuple(parts), a)
    for path, layers in stacked.items():
        _put(tree, path, np.stack(layers))
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
