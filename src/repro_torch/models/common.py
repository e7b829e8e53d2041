"""Shared layers: norms, RoPE, initializers, losses.

Port of ``repro/models/common.py``.  Parameters live in ``nn.Module``s
(``Norm`` here; the attention and MLP modules beside it) under the
reference's names and ``(d_in, d_out)`` layouts.  The reference's logical
sharding axes are ``carry.param_axes``' (by the module that holds each
leaf), and its sharded steps run these layers on DTensors
(``launch/steps.py``); :func:`lookup` gathers a row-sharded table.

Mixed dtypes follow the reference's results: torch does not promote
between bfloat16 and float32 in a matrix product, so :func:`matmul` and
:func:`einsum` cast both operands to the type JAX would give the result.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import (gathered, grad_like, grad_whole_dim,
                              on_local_shards, split_as_rows, splits_rows,
                              whole_dim)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp.matmul`` computes it.

    ``torch.matmul`` folds a 3-D ``a``'s two leading dimensions into one
    (a view) before a 2-D ``b``, and its backward folds the gradient so.
    With the second sharded, as sequence parallelism (or DTensor's own
    choice of layout) shards it, torch 2.11's DTensor cannot fold them
    ("Attempted to flatten multiple dimensions"); later versions fold
    them into strided shards.  So a DTensor ``a`` is gathered along its
    dimension 1 (``gathered``: the all-gather before a product of
    sequence parallelism, whose gradient goes back as the product gives
    it), and so is the gradient that reaches the product's backward
    (``grad_whole_dim``), on every torch version and mesh.  Where ``b``'s
    rows are split over a mesh dimension that replicates ``a`` (the
    attention's output, its heads gathered where they do not split
    evenly, before ``wo``), ``a`` takes its own columns first
    (``split_as_rows``), so that the weight's gradient runs on the rank's
    own rows."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if b.ndim == 2 and a.ndim == 3 and isinstance(a, DTensor):
        a = split_as_rows(gathered(a, 1), b)
        out = torch.matmul(a.to(dt), b.to(dt))
        return grad_whole_dim(out, 1)
    return torch.matmul(a.to(dt), b.to(dt))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: both in the promoted dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``table`` (an embedding).  DTensor indices: each
    rank reads the rows of its own indices from its copy of the table,
    gathered whole first (``dist.sharding.whole_dim``; a row-split table
    breaks DTensor's ``aten.index.Tensor`` rule), and the result keeps
    the indices' layout (``local_rows``).  The table's gradient is then
    each rank's sum over its own indices: a Partial sum over the mesh
    axes that split them, the same on every rank of the others.  The
    rows' gradient, a Partial sum over the model axis where it comes
    from the first products' input gradients, is laid out as the rows
    before the local read's backward (``grad_like``).  DTensor's own
    ``aten.index_put`` backward is never reached: torch 2.11's rule
    rejects every split of the indices ("Shard dim -1 in placements ...
    must be normalized"; on a split sequence a shape mismatch), where
    2.13's splits the gradient by itself."""
    if isinstance(idx, DTensor) and isinstance(table, DTensor):
        table = whole_dim(whole_dim(table, 0), 1)
        local = table.to_local(grad_placements=[
            Partial() if isinstance(p, Shard) else Replicate()
            for p in idx.placements])
        rows = local[idx.to_local().long()]  # local_rows
        shape = tuple(idx.shape) + tuple(table.shape[1:])
        return grad_like(DTensor.from_local(
            rows, idx.device_mesh, idx.placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))
    return whole_dim(table, 0)[idx.long()]


def trunc_normal(generator: torch.Generator, shape, scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn in float32 on the
    generator's device, times ``scale``, cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


# The reference's initializers draw every matrix at ``d_in ** -0.5`` but
# these leaves (by their last name), which they draw at a fixed scale.
DRAW_SCALES = {"embed": 0.02, "dec_pos": 0.02, "conv_w": 0.3}
# Matrices the reference sets to constants (Mamba-1's ``A_log``); the
# module that owns one sets it when it is built.
CONSTANT_MATRICES = ("A_log",)


def draw_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every matrix of ``module`` from ``generator`` in place, as the
    reference's initializers do: truncated normals at ``d_in ** -0.5``
    (``d_in`` the second-to-last axis, so a stacked expert tensor (E, d_in,
    d_out) too), or at the leaf's scale in ``DRAW_SCALES``.  Vectors and
    ``CONSTANT_MATRICES`` keep the values their modules set (biases zero,
    norm weights one, the SSM constants)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim < 2 or leaf in CONSTANT_MATRICES:
                continue
            scale = DRAW_SCALES.get(leaf, p.shape[-2] ** -0.5)
            p.copy_(trunc_normal(generator, p.shape, scale, p.dtype))
    return module


def recompute(fn, *args, remat: bool = True, **kw):
    """``fn(*args, **kw)``, checkpointed when ``remat`` is set and autograd
    records: the reference's ``jax.checkpoint``.  The values are the same
    either way; only what the backward pass keeps differs."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` in JAX's formulation,
    max(x, 0) + log1p(exp(-|x|)) (torch's own softplus switches to x
    above a threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def rms_norm(x, w, eps):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x, w, b, eps):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


class Norm(nn.Module):
    """RMSNorm (``w``) or LayerNorm (``w``, ``b``) by ``cfg.norm``: the
    reference's ``make_norm_params`` and ``apply_norm``."""

    def __init__(self, cfg, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.kind, self.eps = cfg.norm, cfg.norm_eps
        self.w = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        if self.kind != "rmsnorm":
            self.b = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                              device=device))

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rms_norm(x, self.w, self.eps)
        return layer_norm(x, self.w, self.b, self.eps)


# -- rotary position embeddings ---------------------------------------------


def rope_angles(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (...,) int -> (..., head_dim//2) float32 angles.

    The inverse frequencies are computed in float64 and rounded to float32
    before the product, as JAX (64-bit types off) multiplies them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    inv = torch.from_numpy(inv.astype(np.float32)).to(positions.device)
    return positions[..., None].to(torch.float32) * inv[None, :]


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    ang = rope_angles(hd, theta, positions)  # (B, S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cos.ndim == 2:  # (S, hd/2) -> broadcast over batch
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(max_len: int, d: int) -> torch.Tensor:
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((max_len, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


# -- losses ------------------------------------------------------------------


def _nll(logits, labels):
    """Each position's NLL: logsumexp less the label logit."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    return logz - torch.sum(logits * onehot, dim=-1)


def softmax_cross_entropy(logits, labels, mask=None):
    """logits (..., V) any dtype -> fp32 mean NLL over masked positions.

    The label logit is taken by a one-hot contraction, as the reference
    takes it.  Logits split on their rows with the vocabulary whole (the
    LM head on each rank's own rows, ``dist.sharding.on_own_rows``): the
    NLL runs on each rank's local rows (``on_local_shards``), the labels
    and the mask laid out as the logits, so that neither the logits nor
    the (tokens, V) one-hot is gathered."""
    if splits_rows(logits):
        rows = {"batch": 0, "rows": 1}
        nll = on_local_shards(_nll, [logits, labels], [rows, rows],
                              dict(zip(rows, logits.shape[:2])), rows)
        if isinstance(mask, DTensor):
            mask = mask.redistribute(mask.device_mesh, nll.placements)
    else:
        nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
