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
- :func:`params_to_numpy` is its inverse;
- :func:`named_from_reference` gives any tree of that layout (moments,
  gradients) as tensors under the port's names;
- :func:`state_from_reference` and :func:`state_to_numpy` do the same for
  a train state (step, float32 master, m and v; ``optim/adamw.py``);
- :func:`reference_order` sorts the port's names as the reference's
  pytree orders its leaves;
- :func:`param_axes` and :func:`cache_axes` give the reference's logical
  sharding axes (``dist/sharding.py``) of every parameter under the
  port's names, and of every cache leaf, from the config alone.  A
  parameter of an unstacked layer drops the reference's leading
  ``"layers"`` (no rule maps it to a mesh axis); the caches stay stacked
  and keep it.

A model of either package carried from the same arrays computes the same
function, up to the rounding of each package's kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.problem import resolve_device
from .config import ModelConfig
from .registry import empty_model

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


def _unstacked(tree: dict):
    """(the port's name, torch tensor) for every layer of every leaf of
    the reference's ``tree``."""
    for path, arr in _leaves(tree):
        t = _to_torch(arr)
        if path[0] in STACKED:
            for i, part in enumerate(t):
                yield ".".join((path[0], str(i)) + path[1:]), part
        else:
            yield ".".join(path), t


def params_from_reference(cfg: ModelConfig, tree: dict, *, device=None):
    """The port's model (an ``EncDec`` for the enc-dec family, else an
    ``LM``) holding the reference's parameters ``tree`` (numpy arrays;
    bfloat16 ones as JAX hands them to numpy), cast to the dtype of the
    port's parameter (``cfg.dtype``; the MoE router and the SSMs' ``A_log``
    and ``D`` float32), on ``device``."""
    dev = resolve_device(device)
    model = empty_model(cfg, dev)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, part in _named_like(params, _unstacked(tree)).items():
            params[name].copy_(part)
    return model


def _named_like(params: dict, items) -> dict:
    """``items`` (name, tensor) as a dict, checked against ``params``'
    names and shapes."""
    out = {}
    for name, part in items:
        if name not in params:
            raise KeyError(f"the port's model has no {name}")
        p = params[name]
        if tuple(part.shape) != tuple(p.shape):
            raise ValueError(f"{name}: {tuple(part.shape)} into "
                             f"{tuple(p.shape)}")
        out[name] = part
    missing = sorted(set(params) - set(out))
    if missing:
        raise KeyError(f"the reference's tree lacks {missing}")
    return out


def params_to_numpy(model) -> dict:
    """The reference's pytree layout (layers stacked) as float32 numpy
    arrays; a bfloat16 model's values widen exactly."""
    return _tree_from_named(model.named_parameters())


def _tree_from_named(items) -> dict:
    tree: dict = {}
    stacked: dict[tuple, list] = {}
    for name, p in items:
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


# logical axes of each leaf, by the module that holds it (the reference's
# ``init_*`` return them beside their parameters)
_ATTN = {"wq": ("d_model", "heads"), "wk": ("d_model", "kv_heads"),
         "wv": ("d_model", "kv_heads"), "wo": ("heads", "d_model"),
         "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}
_MLP = {"wi": ("d_model", "d_ff"), "wg": ("d_model", "d_ff"),
        "wo": ("d_ff", "d_model"), "bi": ("d_ff",), "bo": ("d_model",)}
_MOE = {"router": ("d_model", "experts"),
        "wi": ("experts", "d_model", "expert_ff"),
        "wg": ("experts", "d_model", "expert_ff"),
        "wo": ("experts", "expert_ff", "d_model")}
_SSM_COMMON = {"in_proj": ("d_model", "d_inner_x2"),
               "conv_w": ("conv", "d_inner"), "conv_b": ("d_inner",),
               "out_proj": ("d_inner", "d_model")}
_MAMBA = {
    1: dict(_SSM_COMMON, x_proj=("d_inner", "ssm_proj"),
            dt_proj=("dt_rank", "d_inner"), dt_bias=("d_inner",),
            A_log=("d_inner", "ssm_state"), D=("d_inner",)),
    2: dict(_SSM_COMMON, A_log=("heads_ssm",), dt_bias=("heads_ssm",),
            D=("heads_ssm",), norm_w=("d_inner",)),
}
_NORM = {"w": ("d_model",), "b": ("d_model",)}
_TOP = {"embed": ("vocab", "d_model"), "lm_head": ("d_model", "vocab"),
        "dec_pos": (None, "d_model")}
_BY_MODULE = {"attn": _ATTN, "self_attn": _ATTN, "cross_attn": _ATTN,
              "mlp": _MLP, "shared": _MLP, "moe": _MOE,
              **{n: _NORM for n in ("ln", "ln1", "ln2", "ln3", "final_norm",
                                    "enc_norm", "dec_norm")}}


def param_axes(cfg: ModelConfig) -> dict:
    """{the port's parameter name: its logical axes}, in the reference's
    leaf order, from ``cfg`` alone (the model is built on the meta
    device)."""
    out = {}
    for name, p in empty_model(cfg, "meta").named_parameters():
        parts = name.split(".")
        if len(parts) == 1:
            table = _TOP
        elif parts[-2] == "ssm":
            table = _MAMBA[cfg.ssm.version]
        else:
            table = _BY_MODULE[parts[-2]]
        axes = table[parts[-1]]
        if len(axes) != p.ndim:
            raise ValueError(f"{name}: axes {axes} for shape {tuple(p.shape)}")
        out[name] = axes
    return {k: out[k] for k in reference_order(out)}


_KV_CACHE = ("layers", "cache_batch", "cache_seq", "cache_kv_heads",
             "cache_hd")


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_lm_cache``'s (or, for the enc-dec
    family, ``init_encdec_cache``'s) tree, layers stacked first."""
    kv = {"k": _KV_CACHE, "v": _KV_CACHE}
    if cfg.family == "encdec":
        return {"self": dict(kv), "cross": dict(kv)}
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        state = (("cache_batch", "d_inner", None) if cfg.ssm.version == 1
                 else ("cache_batch", "heads_ssm", None, None))
        out["ssm"] = {"conv": ("layers", "cache_batch", None, "d_inner"),
                      "ssm": ("layers",) + state}
        if cfg.family == "ssm":
            return out
    out["attn"] = kv
    return out


def reference_key(name: str):
    """Sort key of the port's parameter ``name`` in the reference's leaf
    order: JAX flattens a dict in sorted-key order, and a stacked leaf
    (``blocks/attn/wq``) holds its layers in turn, so ``blocks.3.attn.wq``
    sorts as (("blocks", "attn", "wq"), (3,))."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def reference_order(names) -> list:
    """``names`` sorted by ``reference_key``."""
    return sorted(names, key=reference_key)


def named_from_reference(cfg: ModelConfig, tree: dict, *, device=None
                         ) -> dict:
    """A tree of the reference's parameter layout (parameters, moments or
    gradients; numpy) as float32 tensors under the port's names, in the
    reference's leaf order, on ``device``."""
    dev = resolve_device(device)
    got = _named_like(dict(empty_model(cfg, "meta").named_parameters()),
                      _unstacked(tree))
    return {k: got[k].to(device=dev, dtype=torch.float32)
            for k in reference_order(got)}


def state_from_reference(cfg: ModelConfig, ref_state, device=None):
    """The port's ``TrainState`` from the reference's (``step``, ``params``,
    ``m``, ``v``; numpy arrays, ``jax.tree.map(np.asarray, state)``):
    float32 leaves under the port's names in the reference's leaf order,
    on ``device``."""
    from ..optim.adamw import TrainState

    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(ref_state.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(step, *(named_from_reference(cfg, t, device=dev)
                              for t in (ref_state.params, ref_state.m,
                                        ref_state.v)))


def state_to_numpy(state) -> dict:
    """The port's ``TrainState`` in the reference's layout: ``{"step",
    "params", "m", "v"}``, each tree with its layers stacked, float32
    numpy."""
    out = {"step": np.asarray(int(state.step), np.int32)}
    for field in ("params", "m", "v"):
        out[field] = _tree_from_named(getattr(state, field).items())
    return out
