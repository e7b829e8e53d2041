"""Top-k routed Mixture-of-Experts with capacity buffers + shared experts.

Port of ``repro/models/moe.py``, in plain PyTorch (the reference computes it
outside any Pallas kernel).  Tokens are placed into per-expert capacity
buffers of ``C`` slots by index arithmetic (no (T, E, C) one-hot tensors);
a (token, expert) pair that overflows its expert's buffer is dropped, and
the expert outputs are combined back weighted by the (optionally
re-normalized) top-k router probabilities.

``C`` counts the whole call's tokens: in a batch, one sequence's pairs can
be dropped because of the other sequences' routing, as in the reference.

Supports DeepSeekMoE fine-grained experts + shared experts (an always-on
dense branch) and the Switch-style load-balance aux loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from .common import dtype_of, einsum, matmul
from .mlp import MLP


class MoE(nn.Module):
    """``router`` (d, E), always float32; ``wi``, ``wg`` (E, d, f_e) and
    ``wo`` (E, f_e, d) in ``cfg.dtype``; with shared experts, ``shared``,
    an ``MLP`` of hidden size ``d_ff_shared``: the reference's
    ``init_moe``.  ``forward`` is its ``moe_block``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        m, d = cfg.moe, cfg.d_model
        kw = dict(dtype=dtype_of(cfg.dtype), device=device)
        self.router = nn.Parameter(torch.empty(d, m.n_experts,
                                               dtype=torch.float32,
                                               device=device))
        self.wi = nn.Parameter(torch.empty(m.n_experts, d, m.d_ff_expert, **kw))
        self.wg = nn.Parameter(torch.empty(m.n_experts, d, m.d_ff_expert, **kw))
        self.wo = nn.Parameter(torch.empty(m.n_experts, m.d_ff_expert, d, **kw))
        if m.n_shared_experts:
            self.shared = MLP(cfg, d_ff=m.d_ff_shared, device=device)

    def forward(self, x):
        return moe_block(self.cfg, self, x)


class Routing(NamedTuple):
    probs: torch.Tensor  # (T, E) float32 router probabilities
    gate_vals: torch.Tensor  # (T, k) float32, renormalized if norm_topk_prob
    gate_idx: torch.Tensor  # (T, k) int64 experts, best first
    slot: torch.Tensor  # (T*k,) e*C + position, or E*C (the drop bin)
    keep: torch.Tensor  # (T*k,) bool: the pair fits its expert's buffer
    capacity: int  # C, slots per expert


def capacity(cfg, T: int) -> int:
    """Slots per expert for ``T`` tokens: the reference's Python float
    expression, at least ``top_k``."""
    m = cfg.moe
    C = int((T * m.top_k / m.n_experts) * m.capacity_factor + 0.5)
    return max(C, m.top_k)


def route(cfg, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """Routing of tokens ``xt`` (T, d): float32 softmax router, top-k with
    ``jax.lax.top_k``'s tie rule (the lower expert first among equal
    probabilities: a stable descending sort), and each pair's slot in the
    token-major running count of its expert."""
    m = cfg.moe
    T, E = xt.shape[0], m.n_experts
    # float32 in the model; the train step's compute copy may hand a
    # bfloat16 router, which the product promotes as jnp's does
    logits = matmul(xt.to(torch.float32), router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :m.top_k], gate_idx[:, :m.top_k]
    if m.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    C = capacity(cfg, T)
    flat_e = gate_idx.reshape(-1)
    pos_in_e = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < C
    slot = torch.where(keep, flat_e * C + flat_pos, E * C)
    return Routing(probs, gate_vals, gate_idx, slot, keep, C)


def moe_block(cfg, module: MoE, x):
    """x: (B, S, d) -> (out, aux_loss).

    On DTensors (a sharded step), the capacity dispatch has no sharding
    rule (``index_put_`` by slot into a buffer the block makes, slot counts
    by ``cumsum`` over every token of the call): the tokens and the router
    are gathered (redistributed to Replicate) and the routing, dispatch and
    combine run on each rank's whole local copy, the same on every rank;
    the expert products stay DTensors, experts over the model axis, and
    their output is gathered back.  The output returns to ``x``'s shards
    (a Partial placement of ``x`` as Replicate)."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    if mesh is not None:
        # back to x's layout after (a Partial sum comes back reduced)
        layout = [Replicate() if p.is_partial() else p for p in x.placements]
        x, router = whole(x), whole(module.router)
    else:
        router = module.router
    xt = x.reshape(T, d)
    r = route(cfg, router, xt)
    C = r.capacity

    # Dispatch by index: each kept pair's token id into its slot, then
    # gather rows.  Kept slots are distinct; only dropped pairs share an
    # index, the drop bin E*C, which is sliced off, so the order in which
    # index_put_ writes duplicates there does not matter.
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    tok_for_slot = torch.full((E * C + 1,), T, dtype=torch.int64,
                              device=x.device)
    tok_for_slot[r.slot] = tok_idx
    xpad = torch.cat([xt, xt.new_zeros(1, d)])
    eb = xpad[tok_for_slot[:E * C]].reshape(E, C, d)

    # Expert compute: batched products over the stacked expert weights.
    if mesh is not None:
        eb = replicated(eb, mesh)
    h = F.silu(einsum("ecd,edf->ecf", eb, module.wg)) * einsum(
        "ecd,edf->ecf", eb, module.wi)
    eo = einsum("ecf,efd->ecd", h, module.wo)
    if mesh is not None:
        eo = whole(eo)
    eo = eo.reshape(E * C, d)
    eo = torch.cat([eo, eo.new_zeros(1, d)])

    # Combine: gather back, weight by gate, sum a token's k pairs in slot
    # order from zeros, the order of the reference's scatter-add over a
    # token-major index (no atomics, so the sum is the same on every run).
    back = (eo[r.slot] * r.gate_vals.reshape(-1)[:, None].to(eo.dtype)
            ).view(T, k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + back[:, j].to(x.dtype)

    # Switch-style load-balance loss.
    me = r.probs.mean(0)
    ce = F.one_hot(r.gate_idx[:, 0], E).to(torch.float32).mean(0)
    aux = m.router_aux_coef * E * torch.sum(me * ce)

    if m.n_shared_experts:
        if mesh is None:
            out = out + module.shared(xt)
        else:
            out = out + whole(module.shared(replicated(xt, mesh)))
    out = out.reshape(B, S, d)
    if mesh is None:
        return out, aux
    return (replicated(out, mesh).redistribute(mesh, layout),
            replicated(aux, mesh))


def whole(t: DTensor) -> torch.Tensor:
    """The whole of DTensor ``t`` as this rank's plain tensor: gathered
    (redistributed to Replicate) first, so every rank holds the same."""
    mesh = t.device_mesh
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def replicated(t: torch.Tensor, mesh) -> DTensor:
    """A whole tensor that every rank holds alike, as a replicated
    DTensor."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
