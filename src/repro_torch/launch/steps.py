"""Train / prefill / decode step builders for any (arch x shape).

Port of ``repro/launch/steps.py``.  Each builder returns a ``BuiltStep``
whose ``fn`` runs one step, with the shardings of its arguments
(``in_shardings``), stand-ins for them (``abstract_args``: meta tensors)
and what it chose (``meta``).

On a ``DeviceMesh`` (``launch/mesh.py``) every tensor is a DTensor laid
out by the reference's logical-axis rules (``dist/sharding.py``): the
port's ``NamedSharding`` is a mesh and a ``PartitionSpec`` tuple, whose
``placements`` are DTensor's.  The model's own code runs on DTensors,
under ``implicit_replication`` so that the tensors it makes itself
(positions, masks, RoPE angles) join as replicated; where DTensor has no
sharding rule for an op, the op's module redistributes explicitly and says
so.  On the one-device ``Mesh`` the train step runs on plain tensors,
the shardings are ``torch.device``s, and the serving steps put their
arguments on that device.

``build_train_step``: the float32 masters and AdamW's moments on the
state rules' layout, a compute copy in ``cfg.dtype`` on the compute (or
sequence-parallel, or under ``fsdp`` the state) layout, ``copy_``-ed from
the masters at each step, the loss and its gradients by
``torch.autograd.grad``, widened to float32, brought to the masters'
layout and summed over ``n_acc`` microbatches in order, then AdamW
(``optim/adamw.py``), which updates the state in place (the reference
donates it).  ``abstract_model`` and ``abstract_cache`` are the port's
``jax.eval_shape``: meta tensors and their logical axes.
``build_prefill_step`` and ``build_decode_step`` serve a model whose
parameters and cache are on the serving rules' layout, the cache in the
compute dtype and written in place (the reference donates it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..dist import sharding as shd
from ..models import encdec as encdec_mod
from ..models import transformer as lm_mod
from ..models.carry import cache_axes, param_axes, reference_order
from ..models.common import dtype_of
from ..models.config import ModelConfig, ShapeConfig
from ..models.registry import (batch_shapes, empty_model, init_model,
                               input_specs, loss_fn)
from ..optim.adamw import OptConfig, TrainState, apply_updates, init_state
from .mesh import Mesh


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    in_shardings: tuple  # NamedShardings on a DeviceMesh; else devices
    out_shardings: Any
    abstract_args: tuple  # meta tensors
    meta: dict


def abstract_model(cfg: ModelConfig):
    """({parameter name: meta tensor}, {name: logical axes}), in the
    reference's leaf order, without allocating."""
    params = dict(empty_model(cfg, "meta").named_parameters())
    axes = param_axes(cfg)
    return {k: params[k].detach() for k in axes}, axes


def _cache_for(cfg: ModelConfig, shape: ShapeConfig, dtype, device):
    if cfg.family == "encdec":
        return encdec_mod.init_encdec_cache(
            cfg, shape.global_batch, shape.seq_len, shape.seq_len, dtype,
            device=device)
    return lm_mod.init_lm_cache(cfg, shape.global_batch, shape.seq_len,
                                dtype, device=device)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, dtype):
    """(the decode cache of ``shape`` as meta tensors, its logical axes)."""
    return _cache_for(cfg, shape, dtype, "meta"), cache_axes(cfg)


# -- placing tensors ----------------------------------------------------------


def _as_tensor(v) -> torch.Tensor:
    """numpy inputs (the data pipeline's) or tensors; a DTensor is
    gathered whole (an explicit collective) to be laid out again."""
    if isinstance(v, DTensor):
        return v.full_tensor()
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v))


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: _as_tensor(v).to(device) for k, v in batch.items()}


def put(t, sharding):
    """``t`` (numpy or a tensor: the whole of it, the same on every rank)
    on ``sharding`` (``dist.sharding.put``)."""
    return shd.put(_as_tensor(t), sharding)


def _set_param(model: nn.Module, name: str, value: torch.Tensor):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    setattr(mod, leaf, nn.Parameter(value, requires_grad=value.requires_grad))


def shard_model(model: nn.Module, shardings: dict) -> nn.Module:
    """Lay ``model``'s parameters out on ``shardings`` ({name:
    NamedSharding}), in place; returns the model."""
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            _set_param(model, name, put(p.detach(), shardings[name])
                       .requires_grad_(False))
    return model


def shard_tree(tree: dict, shardings: dict) -> dict:
    """A nested dict of whole tensors on a matching tree of shardings."""
    return shd.tree_map(put, tree, shardings)


def _full(v):
    return v.full_tensor() if isinstance(v, DTensor) else v


# -- train ---------------------------------------------------------------------


def _gqa_specs(cfg, mesh, rules_c, mode):
    """The reference's GQA pinning: with ``n_kv_heads`` not a multiple of
    the model axis, q sharded on heads and k/v replicated over ``model``,
    so score contractions never split ``head_dim``."""
    if mode == "seq" or cfg.family not in ("dense", "vlm", "moe"):
        return {}
    if cfg.n_kv_heads % shd.mesh_shape(mesh)["model"] == 0:
        return {}
    bx = rules_c.rules["batch"]
    return dict(q_spec=shd.NamedSharding(mesh, (bx, None, "model", None)),
                kv_spec=shd.NamedSharding(mesh, (bx, None, None, None)))


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     opt: OptConfig = OptConfig(), *, n_acc: Optional[int] = None,
                     remat: bool = True, fsdp: Optional[bool] = None,
                     masked: bool = False, mode: str = "tp") -> BuiltStep:
    """One optimizer step of ``cfg`` on batches of ``shape`` on ``mesh``: a
    ``DeviceMesh`` (DTensors) or the one-device ``Mesh`` (plain tensors).
    ``masked``: the batch carries the data pipeline's ``loss_mask``;
    ``mode="seq"``: sequence parallelism."""
    rules_c = (shd.train_seqpar_rules(mesh) if mode == "seq"
               else shd.train_compute_rules(mesh))
    n_acc = n_acc or shape.microbatch or 1
    assert shape.global_batch % n_acc == 0
    # each microbatch must still shard over every batch axis
    batch_ways = shd._mesh_axis_size(mesh, rules_c.rules["batch"])
    while n_acc > 1 and (shape.global_batch // n_acc) % batch_ways:
        n_acc //= 2
    if fsdp is None:
        # the reference's rule: ZeRO-3 when the tensor-parallel bfloat16
        # copy would exceed 2.5 GB per device
        fsdp = 2 * cfg.param_count() / shd.mesh_shape(mesh)["model"] > 2.5e9
    loss_kw = {}
    if mode == "seq":
        # the reference's sequence parallelism: the whole sequence is one
        # attention q chunk
        loss_kw = dict(q_chunk=shape.seq_len, kv_chunk=1024)
    if isinstance(mesh, Mesh):
        return _one_device_train_step(cfg, shape, mesh, opt, n_acc=n_acc,
                                      remat=remat, fsdp=fsdp, masked=masked,
                                      mode=mode, loss_kw=loss_kw)
    return _sharded_train_step(cfg, shape, mesh, opt, rules_c, n_acc=n_acc,
                               remat=remat, fsdp=fsdp, masked=masked,
                               mode=mode, loss_kw=loss_kw)


def _sharded_train_step(cfg, shape, mesh, opt, rules_c, *, n_acc, remat,
                        fsdp, masked, mode, loss_kw) -> BuiltStep:
    rules_s = shd.train_state_rules(mesh)
    loss = loss_fn(cfg)
    p_shapes, axes = abstract_model(cfg)
    names = list(axes)
    compute_sh = shd.tree_shardings(rules_s if fsdp else rules_c, p_shapes,
                                    axes)
    master_sh = shd.tree_shardings(rules_s, p_shapes, axes)
    rep = shd.NamedSharding(mesh, ())
    state_sh = TrainState(rep, master_sh, master_sh, master_sh)
    specs = input_specs(cfg, shape, masked=masked)
    b_sh = shd.batch_shardings(rules_c, specs)
    mb_shape = dataclasses.replace(shape,
                                   global_batch=shape.global_batch // n_acc)
    mb_sh = shd.batch_shardings(rules_c, input_specs(cfg, mb_shape,
                                                     masked=masked))
    pin = _gqa_specs(cfg, mesh, rules_c, mode)
    cdt = dtype_of(cfg.dtype)

    # the compute copy: a module of the config's family whose parameters
    # are DTensors on the compute layout, in the compute dtype
    model = empty_model(cfg, "meta")
    for k in names:
        _set_param(model, k, torch.distributed.tensor.empty(
            p_shapes[k].shape, dtype=cdt, device_mesh=mesh,
            placements=compute_sh[k].placements, requires_grad=True))
    params_c = dict(model.named_parameters())

    def value_and_grad(mb):
        with implicit_replication():
            l = loss(cfg, model, mb, remat=remat, **loss_kw, **pin)
            plist = [params_c[k] for k in names]
            gs = torch.autograd.grad(l, plist, allow_unused=True)
        out = {}
        for k, p, g in zip(names, plist, gs):
            if g is None:
                out[k] = torch.distributed.tensor.zeros(
                    p.shape, dtype=torch.float32, device_mesh=mesh,
                    placements=master_sh[k].placements)
            else:  # the reduction to the masters' layout, in float32
                out[k] = shd.constrain(g.to(torch.float32), master_sh[k])
        return l.detach(), out

    def loss_and_grads(state: TrainState, batch: dict, *, loop=range):
        """The step's loss (a plain scalar) and float32 gradients on the
        masters' layout (the microbatches' mean), with no update.
        ``loop(n_acc)`` yields the microbatches to run: all of them, unless
        the dry run's cost model runs one trip weighted by ``n_acc``
        (``launch/dryrun.py``)."""
        if set(batch) != set(specs):
            raise ValueError(
                f"the batch's inputs {sorted(batch)} are not the step's "
                f"{sorted(specs)}: the symmetric difference on key sets is "
                f"{sorted(set(batch) ^ set(specs))}")
        batch = {k: _as_tensor(v) for k, v in batch.items()}
        with torch.no_grad():
            for k in names:
                params_c[k].copy_(shd.constrain(state.params[k],
                                                compute_sh[k]))
        if n_acc == 1:
            l, g = value_and_grad({k: put(t, b_sh[k])
                                   for k, t in batch.items()})
            return _full(l), g
        mb = shape.global_batch // n_acc
        grads = {k: torch.distributed.tensor.zeros(
            p_shapes[k].shape, dtype=torch.float32, device_mesh=mesh,
            placements=master_sh[k].placements) for k in names}
        lsum = None
        for i in loop(n_acc):
            l, g = value_and_grad({k: put(t[i * mb:(i + 1) * mb], mb_sh[k])
                                   for k, t in batch.items()})
            for k, t in g.items():
                grads[k].add_(t)
            del g
            lsum = l if lsum is None else lsum + l
        for t in grads.values():
            t.div_(n_acc)
        return _full(lsum / n_acc), grads

    def train_step(state: TrainState, batch: dict, *, loop=range):
        l, grads = loss_and_grads(state, batch, loop=loop)
        with implicit_replication():
            new_state, metrics = apply_updates(opt, state, grads)
        return new_state, dict({k: _full(v) for k, v in metrics.items()},
                               loss=l)

    leaves = {k: p_shapes[k].to(torch.float32) for k in names}
    abstract_state = TrainState(torch.empty((), dtype=torch.int32,
                                            device="meta"),
                                leaves, dict(leaves), dict(leaves))
    return BuiltStep(
        fn=train_step,
        in_shardings=(state_sh, b_sh),
        out_shardings=(state_sh, None),
        abstract_args=(abstract_state, specs),
        meta=dict(kind="train", n_acc=n_acc, rules_c=rules_c,
                  rules_s=rules_s, compute_shardings=compute_sh, axes=axes,
                  param_shapes={k: tuple(p_shapes[k].shape) for k in names},
                  fsdp=fsdp, mode=mode, masked=masked, remat=remat,
                  loss_kw=loss_kw, kv_replicated=bool(pin), mesh=mesh,
                  device=torch.device(mesh.device_type), compute_model=model,
                  loss_and_grads=loss_and_grads),
    )


def _one_device_train_step(cfg, shape, mesh, opt, *, n_acc, remat, fsdp,
                           masked, mode, loss_kw) -> BuiltStep:
    """The train step on plain tensors on ``mesh.device``.  The sharding
    arguments change nothing here (``mode="seq"`` still sets the
    reference's attention chunks); ``in_shardings`` holds devices."""
    device = mesh.device
    loss = loss_fn(cfg)
    cdt = dtype_of(cfg.dtype)
    model = empty_model(cfg, device).to(cdt)
    params_c = dict(model.named_parameters())
    names = reference_order(params_c)
    specs = batch_shapes(cfg, shape, masked=masked)
    kv_replicated = (mode != "seq" and cfg.family in ("dense", "vlm", "moe")
                     and cfg.n_kv_heads % mesh.shape["model"] != 0)

    def value_and_grad(mb):
        l = loss(cfg, model, mb, remat=remat, **loss_kw)
        plist = [params_c[k] for k in names]
        gs = torch.autograd.grad(l, plist, allow_unused=True)
        return l.detach(), {k: (torch.zeros_like(p) if g is None else g)
                            for k, p, g in zip(names, plist, gs)}

    def loss_and_grads(state: TrainState, batch: dict, *, loop=range):
        """The step's loss and float32 gradients (the microbatches'
        mean), with no update; ``loop`` as on a ``DeviceMesh``."""
        if set(batch) != set(specs):
            raise ValueError(
                f"the batch's inputs {sorted(batch)} are not the step's "
                f"{sorted(specs)}: the symmetric difference on key sets is "
                f"{sorted(set(batch) ^ set(specs))}")
        batch = _to_device(batch, device)
        with torch.no_grad():
            for k in names:
                params_c[k].copy_(state.params[k])
        if n_acc == 1:
            l, g = value_and_grad(batch)
            return l, {k: t.to(torch.float32) for k, t in g.items()}
        mbs = {k: t.reshape((n_acc, t.shape[0] // n_acc) + t.shape[1:])
               for k, t in batch.items()}
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in state.params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        for i in loop(n_acc):
            l, g = value_and_grad({k: t[i] for k, t in mbs.items()})
            for k, t in g.items():
                grads[k].add_(t.to(torch.float32))
            del g
            lsum = lsum + l
        for t in grads.values():
            t.div_(n_acc)
        return lsum / n_acc, grads

    def train_step(state: TrainState, batch: dict, *, loop=range):
        l, grads = loss_and_grads(state, batch, loop=loop)
        new_state, metrics = apply_updates(opt, state, grads)
        return new_state, dict(metrics, loss=l)

    state_devices = TrainState(device, {k: device for k in names},
                               {k: device for k in names},
                               {k: device for k in names})
    b_devices = {k: device for k in specs}

    def meta_tensor(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    leaves = {k: meta_tensor(params_c[k].shape, torch.float32) for k in names}
    abstract_state = TrainState(meta_tensor((), torch.int32), leaves,
                                dict(leaves), dict(leaves))
    abstract_batch = {k: meta_tensor(s, d) for k, (s, d) in specs.items()}
    return BuiltStep(
        fn=train_step,
        in_shardings=(state_devices, b_devices),
        out_shardings=(state_devices, None),
        abstract_args=(abstract_state, abstract_batch),
        meta=dict(kind="train", n_acc=n_acc, fsdp=fsdp, mode=mode,
                  masked=masked, remat=remat, loss_kw=loss_kw,
                  kv_replicated=kv_replicated, device=device,
                  compute_model=model, loss_and_grads=loss_and_grads,
                  param_shapes={k: tuple(params_c[k].shape) for k in names}),
    )


def init_train_state(cfg: ModelConfig, built: BuiltStep, seed: int = 0
                     ) -> TrainState:
    """The model drawn from a generator seeded ``seed`` on the step's
    device (in ``cfg.dtype``, as the reference draws it), as a float32
    train state there; on a ``DeviceMesh`` every rank draws the same
    tensors and keeps its shards of them (the same whole tensors for any
    mesh)."""
    device = built.meta["device"]
    model = init_model(cfg, torch.Generator(device=device).manual_seed(seed),
                       device=device)
    state = init_state(dict(model.named_parameters()))
    del model
    if "mesh" not in built.meta:
        return state
    return shard_state(state, built.in_shardings[0])


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """A train state of whole tensors laid out on ``shardings`` (a
    ``TrainState`` of NamedShardings)."""
    return TrainState(put(state.step, shardings.step),
                      *(shard_tree(getattr(state, f), getattr(shardings, f))
                        for f in ("params", "m", "v")))


# -- serving -------------------------------------------------------------------


def _serve_shardings(cfg, shape, mesh):
    rules = shd.serve_rules(mesh, batch=shape.global_batch,
                            kv_heads=cfg.n_kv_heads, seq=shape.seq_len)
    cdt = dtype_of(cfg.dtype)
    p_shapes, axes = abstract_model(cfg)
    cache_shapes, c_axes = abstract_cache(cfg, shape, cdt)
    return (rules, cdt, p_shapes, axes, shd.tree_shardings(rules, p_shapes, axes),
            cache_shapes, c_axes, shd.tree_shardings(rules, cache_shapes, c_axes))


def init_cache(built: BuiltStep) -> dict:
    """A zero cache of the step's shape in the compute dtype, laid out on
    its shardings (each rank allocates only its shards)."""
    def zeros(meta, sharding):
        if isinstance(sharding.mesh, Mesh):
            return torch.zeros(meta.shape, dtype=meta.dtype,
                               device=sharding.mesh.device)
        return torch.distributed.tensor.zeros(
            meta.shape, dtype=meta.dtype, device_mesh=sharding.mesh,
            placements=sharding.placements)
    return shd.tree_map(zeros, built.abstract_args[1], built.in_shardings[1])


def _write_back(cache: dict, new: dict):
    """``new``'s leaves copied into ``cache``'s where they are other
    tensors (the enc-dec prefill makes its cross K/V anew)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(cache[k], v)
        elif v is not cache[k]:
            lm_mod.write(cache[k], v)


def _replicated_zeros(shape_, mesh, device):
    t = torch.zeros(shape_, dtype=torch.float32, device=device)
    return shd.put(t, shd.NamedSharding(mesh, ()))


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> BuiltStep:
    """``fn(model, cache, token, pos) -> (logits, cache)``: one decode step
    of a model whose parameters are on ``in_shardings[0]``
    (``shard_model``), the cache (``init_cache``) written in place."""
    (rules, cdt, p_shapes, axes, p_sh, cache_shapes, c_axes,
     c_sh) = _serve_shardings(cfg, shape, mesh)
    rep = shd.NamedSharding(mesh, ())
    tok_sh = rules.sharding(("batch", None), (shape.global_batch, 1))
    step = (encdec_mod.encdec_decode_step if cfg.family == "encdec"
            else lm_mod.lm_decode_step)

    def decode(model, cache, token, pos):
        with implicit_replication():
            return step(cfg, model, put(token, tok_sh), cache, pos)

    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                      device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return BuiltStep(
        fn=decode,
        in_shardings=(p_sh, c_sh, tok_sh, rep),
        out_shardings=(None, c_sh),
        abstract_args=(p_shapes, cache_shapes, tok, pos),
        meta=dict(kind="decode", rules=rules, axes=axes, cache_axes=c_axes,
                  param_shapes=p_shapes, mesh=mesh),
    )


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> BuiltStep:
    """``fn(model, cache, batch) -> (logits, cache)``: the prompt's
    last-token logits (zeros (B, 1, vocab) for the enc-dec family, whose
    prefill runs the encoder), the cache written in place."""
    (rules, cdt, p_shapes, axes, p_sh, cache_shapes, c_axes,
     c_sh) = _serve_shardings(cfg, shape, mesh)
    specs = input_specs(cfg, shape)
    b_sh = shd.batch_shardings(rules, specs)

    def prefill(model, cache, batch):
        batch = {k: put(v, b_sh[k]) for k, v in batch.items()}
        with implicit_replication():
            if cfg.family == "encdec":
                frames = batch["frames"]
                new, _ = encdec_mod.encdec_prefill(cfg, model, frames, cache)
                _write_back(cache, new)
                return _replicated_zeros((frames.shape[0], 1, cfg.vocab),
                                         mesh, frames.device), cache
            return lm_mod.lm_prefill(cfg, model, batch["tokens"], cache,
                                     patch_embeds=batch.get("patch_embeds"))

    return BuiltStep(
        fn=prefill,
        in_shardings=(p_sh, c_sh, b_sh),
        out_shardings=(None, c_sh),
        abstract_args=(p_shapes, cache_shapes, specs),
        meta=dict(kind="prefill", rules=rules, axes=axes, cache_axes=c_axes,
                  param_shapes=p_shapes, mesh=mesh),
    )


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, mesh)
    raise ValueError(shape.kind)
