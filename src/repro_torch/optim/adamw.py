"""AdamW + global-norm clipping + warmup-cosine schedule.

Port of ``repro/optim/adamw.py``.  The train state keeps float32 *master*
params and moments as dicts of tensors under the port's parameter names
(``blocks.3.attn.wq``), ordered as the reference's pytree orders its
leaves (``models.carry.reference_order``): sorted keys, a stacked leaf's
layers in turn.  The forward/backward pass consumes a copy in the compute
dtype (``launch/steps.py``).

``apply_updates`` writes the new params and moments into the state's
tensors, under ``torch.no_grad()``: the port's form of the reference's
donated state (``donate_argnums=(0,)``), so one copy of the state lives on
the device.  Its arithmetic is the reference's, in its order: the clip
scale, the bias corrections, then per leaf ``m``, ``v`` and the update
with the decoupled weight decay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.carry import reference_order


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: dict  # name -> float32 master
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine down to ``min_lr_frac`` of
    it, in float32 on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params: dict) -> TrainState:
    """Step 0, float32 copies of ``params`` (name -> tensor) in the
    reference's leaf order, and zero moments."""
    names = reference_order(params)
    f32 = {k: params[k].detach().to(torch.float32, copy=True) for k in names}
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(f32.values())).device)
    return TrainState(step, f32,
                      {k: torch.zeros_like(t) for k, t in f32.items()},
                      {k: torch.zeros_like(t) for k, t in f32.items()})


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares, each leaf summed on its own, the
    leaves added in the dict's order (the reference's leaf order)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree.values()))


@torch.no_grad()
def apply_updates(cfg: OptConfig, state: TrainState, grads: dict
                  ) -> tuple[TrainState, dict]:
    """One AdamW step with ``grads`` (name -> tensor, any float dtype).
    Updates ``state.params``, ``state.m`` and ``state.v`` in place and
    returns (the state with the next step, {"grad_norm", "lr"})."""
    if list(grads) != list(state.params):
        grads = {k: grads[k] for k in state.params}
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)

    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    for k, p in state.params.items():
        g = grads[k].to(torch.float32) * scale
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        p.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p))
    return (TrainState(step, state.params, state.m, state.v),
            {"grad_norm": gn, "lr": lr})
