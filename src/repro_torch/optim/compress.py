"""Gradient compression: int8 stochastic quantization + error feedback.

Port of ``repro/optim/compress.py``.  Each rank quantizes its gradients to
int8 with a per-tensor scale before the cross-rank sum; the quantization
error is carried in an error state and added back next step (error
feedback; Karimireddy et al., 2019).  The reference's ``psum`` inside
``shard_map`` becomes a ``torch.distributed`` ``all_reduce`` of the int8
values widened to int32 over ``group``; with no group the world is one
rank and no collective runs, as a ``psum`` over an axis of size 1.  As in
the reference, each rank scales the summed integers by its *own* scale.

The noise is uniform on [-0.5, 0.5), drawn per leaf from a
``torch.Generator`` (``compress_all_reduce``); ``compress_with_noise``
takes the draws, so a caller can feed any stream (the reference's).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def init_error_state(params: dict) -> dict:
    return {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for k, t in params.items()}


def quantize_int8(g: torch.Tensor, noise: torch.Tensor):
    """Stochastic int8 quantization with a per-tensor scale: (q, scale)."""
    # XLA folds the reference's division by the constant 127 into a
    # product with its float32 reciprocal; so does the port
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) * (1.0 / 127.0)
    scaled = g / scale
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def compress_with_noise(grads: dict, err: dict, noise: dict, group=None):
    """int8 + error-feedback sum of ``grads`` (name -> tensor) over the
    ranks of ``group`` (None: this rank alone), with ``noise[name]`` as
    the rounding noise.  Returns (the reduced float32 grads, the new error
    state)."""
    n = 1 if group is None else dist.get_world_size(group)
    outs, new_errs = {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + err[k]
        q, scale = quantize_int8(g32, noise[k].to(g32.device))
        deq = q.to(torch.float32) * scale
        new_errs[k] = g32 - deq
        # int8 values cross the wire; sum in int32 to avoid overflow
        red = q.to(torch.int32)
        if group is not None:
            dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
        outs[k] = red.to(torch.float32) * scale / n
    return outs, new_errs


def compress_all_reduce(grads: dict, err: dict, generator: torch.Generator,
                        group=None):
    """``compress_with_noise`` with U[-0.5, 0.5) noise drawn from
    ``generator``, one leaf after another in ``grads``' order."""
    noise = {k: torch.rand(g.shape, generator=generator, dtype=torch.float32,
                           device=generator.device) - 0.5
             for k, g in grads.items()}
    return compress_with_noise(grads, err, noise, group)
