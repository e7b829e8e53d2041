"""Train step builder for any (arch x shape), on one device.

Port of the training half of ``repro/launch/steps.py``.  ``build_train_step``
returns a ``BuiltStep`` whose ``fn(state, batch)`` is one optimizer step:
the float32 masters cast to the compute dtype (every leaf, as the
reference casts them: a bfloat16 config's MoE router and SSM ``A_log`` and
``D`` too), the loss and its gradients with respect to that copy, widened
to float32 and summed over ``n_acc`` microbatches in order, then AdamW
(``optim/adamw.py``), which updates the state in place.  The compute copy
is a module of the config's family whose parameters are ``copy_``-ed from
the masters at each step; gradients come from ``torch.autograd.grad``, so
nothing accumulates in ``.grad``.

The reference's sharding arguments have no effect on one device: ``fsdp``,
``mode`` and the GQA pinning go into ``meta`` (``mode="seq"`` still sets
the reference's attention chunks).  ``in_shardings`` holds the state's and
the batch's ``torch.device``s, which ``ckpt.restore`` takes.  The serving
builders (``build_prefill_step``, ``build_decode_step``) and
``abstract_model`` wait for the dry-run port (ROADMAP Queue 1 item 17).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.carry import reference_order
from ..models.common import dtype_of
from ..models.config import ModelConfig, ShapeConfig
from ..models.registry import batch_shapes, empty_model, init_model, loss_fn
from ..optim.adamw import OptConfig, TrainState, apply_updates, init_state


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    in_shardings: tuple  # (TrainState of devices, {input: device})
    out_shardings: Any
    abstract_args: tuple  # (TrainState, batch) of meta tensors
    meta: dict


def _to_device(batch: dict, device: torch.device) -> dict:
    """numpy inputs (the data pipeline's) or tensors, on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(device)
            for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     opt: OptConfig = OptConfig(), *, n_acc: Optional[int] = None,
                     remat: bool = True, fsdp: Optional[bool] = None,
                     masked: bool = False, mode: str = "tp") -> BuiltStep:
    """One optimizer step of ``cfg`` on batches of ``shape`` on
    ``mesh.device`` (a ``launch.mesh`` one-device mesh).  ``masked``: the
    batch carries the data pipeline's ``loss_mask``."""
    device = mesh.device
    loss = loss_fn(cfg)
    n_acc = n_acc or shape.microbatch or 1
    assert shape.global_batch % n_acc == 0
    if fsdp is None:
        # the reference's rule: ZeRO-3 when the tensor-parallel bfloat16
        # copy would exceed 2.5 GB per device
        fsdp = 2 * cfg.param_count() / mesh.shape["model"] > 2.5e9
    cdt = dtype_of(cfg.dtype)
    model = empty_model(cfg, device).to(cdt)
    params_c = dict(model.named_parameters())
    names = reference_order(params_c)

    specs = batch_shapes(cfg, shape, masked=masked)
    loss_kw = {}
    if mode == "seq":
        # the reference's sequence parallelism: the whole sequence is one
        # attention q chunk
        loss_kw = dict(q_chunk=shape.seq_len, kv_chunk=1024)
    kv_replicated = (mode != "seq" and cfg.family in ("dense", "vlm", "moe")
                     and cfg.n_kv_heads % mesh.shape["model"] != 0)

    def value_and_grad(mb):
        l = loss(cfg, model, mb, remat=remat, **loss_kw)
        plist = [params_c[k] for k in names]
        gs = torch.autograd.grad(l, plist, allow_unused=True)
        return l.detach(), {k: (torch.zeros_like(p) if g is None else g)
                            for k, p, g in zip(names, plist, gs)}

    def loss_and_grads(state: TrainState, batch: dict):
        """The step's loss and float32 gradients (the microbatches'
        mean), with no update."""
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
        for i in range(n_acc):
            l, g = value_and_grad({k: t[i] for k, t in mbs.items()})
            for k, t in g.items():
                grads[k].add_(t.to(torch.float32))
            del g
            lsum = lsum + l
        for t in grads.values():
            t.div_(n_acc)
        return lsum / n_acc, grads

    def train_step(state: TrainState, batch: dict):
        l, grads = loss_and_grads(state, batch)
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
    train state there."""
    device = built.meta["device"]
    model = init_model(cfg, torch.Generator(device=device).manual_seed(seed),
                       device=device)
    state = init_state(dict(model.named_parameters()))
    del model
    return state

