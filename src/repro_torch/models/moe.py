"""Top-k routed Mixture-of-Experts with capacity buffers + shared experts.

Port of ``repro/models/moe.py``, in plain PyTorch (the reference computes it
outside any Pallas kernel).  Tokens are placed into per-expert capacity
buffers of ``C`` slots by index arithmetic (no (T, E, C) one-hot tensors);
a (token, expert) pair that overflows its expert's buffer is dropped, and
the expert outputs are combined back weighted by the (optionally
re-normalized) top-k router probabilities.

``C`` counts the whole call's tokens: in a batch, one sequence's pairs can
be dropped because of the other sequences' routing, as in the reference.
On a mesh (DTensors) each rank routes its own tokens and runs its own
experts on its own capacity slots (``sharded_moe``), as GSPMD splits the
reference's program; the slots stay those of the whole call.

Supports DeepSeekMoE fine-grained experts + shared experts (an always-on
dense branch) and the Switch-style load-balance aux loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import chunk_of, whole_local
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


def gates(cfg, router: torch.Tensor, xt: torch.Tensor):
    """(probs, gate values, experts) of tokens ``xt`` (T, d): float32
    softmax router and top-k with ``jax.lax.top_k``'s tie rule (the lower
    expert first among equal probabilities: a stable descending sort),
    the gate values renormalized if ``norm_topk_prob``."""
    m = cfg.moe
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
    return probs, gate_vals, gate_idx


def slots(cfg, gate_idx: torch.Tensor):
    """(slot, keep, C) of the experts ``gate_idx`` (T, k) of a call's
    tokens: each pair's slot in the token-major running count of its
    expert, e*C + position, or E*C (the drop bin) where the pair overflows
    its expert's C slots."""
    E = cfg.moe.n_experts
    C = capacity(cfg, gate_idx.shape[0])
    flat_e = gate_idx.reshape(-1)
    pos_in_e = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < C
    slot = torch.where(keep, flat_e * C + flat_pos, E * C)
    return slot, keep, C


def route(cfg, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """Routing of tokens ``xt`` (T, d): ``gates`` and ``slots``."""
    probs, gate_vals, gate_idx = gates(cfg, router, xt)
    return Routing(probs, gate_vals, gate_idx, *slots(cfg, gate_idx))


def moe_block(cfg, module: MoE, x):
    """x: (B, S, d) -> (out, aux_loss).  DTensors: ``sharded_moe``."""
    if isinstance(x, DTensor):
        return sharded_moe(cfg, module, x)
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    xt = x.reshape(T, d)
    r = route(cfg, module.router, xt)
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
    eo = _experts(eb, module.wi, module.wg, module.wo).reshape(E * C, d)
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
        out = out + module.shared(xt)
    return out.reshape(B, S, d), aux


def _experts(eb, wi, wg, wo):
    """The expert products of capacity buffers ``eb`` (E, C, d) with the
    stacked weights: SwiGLU, (E, C, d) out."""
    h = F.silu(einsum("ecd,edf->ecf", eb, wg)) * einsum("ecd,edf->ecf", eb,
                                                         wi)
    return einsum("ecf,efd->ecd", h, wo)


def sharded_moe(cfg, module: MoE, x: DTensor):
    """``moe_block`` on a mesh, each rank on its own share, as GSPMD splits
    the reference's index dispatch over the data and the model axes.

    - Routing: the router product, softmax and top-k of the rank's own
      tokens (``x`` laid out on its tokens alone: its split of the batch
      or the sequence kept), the router read whole; its gradient is a
      Partial sum over the mesh dimensions that split the tokens.
    - Slots: only the integer experts (T, k) are gathered; every rank
      counts the slots of the whole call as one device does (C counts
      every token: one data rank's pairs are dropped because of the
      others' routing).
    - Experts: a rank runs its model rank's experts (or, where the model
      axis splits the experts' hidden size instead, all experts on its
      own columns) on its data ranks' capacity rows ``chunk_of`` C (pod
      x data; unevenly where the data ways do not divide C), as plain
      batched products on its local weights and on the rows of its
      slots, read from ``x`` gathered whole.  The weights' gradients are
      Partial sums over the data axes, the tokens' over every axis that
      splits the block (``whole_local``).
    - Combine: the rank's outputs, weighted by their gates, summed into a
      (T, d) buffer of zeros at their tokens in slot order j = 0..k-1; the
      buffer, a Partial sum over the block's axes, is reduce-scattered
      into ``x``'s token layout and stays a Partial sum over the model
      axis, as the shared experts' row-split output does, for the
      block's ``summed``.
    - Shared experts: the dense ``MLP`` on ``x`` in its own layout.
    - Aux loss: the reference's over all tokens, the mean router
      probabilities summed over the ranks that split the tokens, the
      top-1 counts from the gathered experts.

    Returns (out, aux), a replicated aux."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    mesh = x.device_mesh
    n = mesh.ndim
    # the tokens' layout: a split of the batch or the sequence kept, any
    # other placement (a Partial sum, a split of d_model) made whole
    tok_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                   else Replicate() for p in x.placements)
    if tuple(x.placements) != tok_pl:
        x = x.redistribute(mesh, tok_pl)
    tok_dims = [j for j, p in enumerate(tok_pl)
                if isinstance(p, Shard) and mesh.size(j) > 1]
    names = list(mesh.mesh_dim_names or ())
    mj = names.index("model") if "model" in names else None
    # the expert block: the model axis splits the experts (or their
    # hidden size), the other axes the capacity rows
    wi_pl = module.wi.placements[mj] if mj is not None else Replicate()
    by_model = isinstance(wi_pl, Shard) and mesh.size(mj) > 1
    c_dims = [j for j in range(n) if j != mj]
    c_part = [j for j in c_dims if mesh.size(j) > 1]
    part = c_part + ([mj] if by_model else [])

    xl = x.to_local()
    probs, gate_vals, gate_idx = gates(
        cfg, whole_local(module.router, partial=tok_dims), xl.reshape(-1, d))

    def by_token(t):  # the rank's (tokens, c) as a DTensor of (B, S, c)
        c = t.shape[-1]
        t = t.reshape(*xl.shape[:2], c).contiguous()
        return DTensor.from_local(t, mesh, tok_pl,
                                  run_check=False, shape=(B, S, c),
                                  stride=(S * c, c, 1))

    gate_idx = whole_local(by_token(gate_idx)).reshape(T, k)
    gate_vals = whole_local(by_token(gate_vals), partial=part).reshape(-1)
    slot, _, C = slots(cfg, gate_idx)

    # the pair (t*k + j) in each slot, T*k where empty; the rank's block
    pair_for_slot = torch.full((E * C + 1,), T * k, dtype=torch.int64,
                               device=xl.device)
    pair_for_slot[slot] = torch.arange(T * k, device=xl.device)
    e0, e1 = 0, E
    if by_model and wi_pl.dim == 0:
        e0, e1 = chunk_of(mesh, [mj], E)
    c0, c1 = chunk_of(mesh, c_dims, C)
    block = pair_for_slot[:E * C].view(E, C)[e0:e1, c0:c1].reshape(-1)
    tok, jdx = block // k, block % k

    xw = whole_local(x, partial=part).reshape(T, d)
    eb = torch.cat([xw, xw.new_zeros(1, d)])[tok].view(e1 - e0, c1 - c0, d)
    keep = [mj] if by_model else []
    eo = _experts(eb, *(whole_local(w, keep=keep, partial=c_part)
                        for w in (module.wi, module.wg, module.wo)))

    gpad = torch.cat([gate_vals, gate_vals.new_zeros(1)])
    vals = (eo.reshape(-1, d) * gpad[block][:, None].to(eo.dtype)
            ).to(x.dtype)
    out = torch.zeros((T + 1, d), dtype=x.dtype, device=xl.device)
    for j in range(k):
        # a token's j-th pair, if in the block; every other row to row T
        out.index_add_(0, torch.where(jdx == j, tok, T), vals)
    out = DTensor.from_local(
        out[:T].view(B, S, d), mesh,
        [Partial() if j in part else Replicate() for j in range(n)],
        run_check=False)
    out = out.redistribute(mesh, [Partial() if j == mj and by_model
                                  else tok_pl[j] for j in range(n)])

    # Switch-style load-balance loss over every token of the call.
    me = whole_local(DTensor.from_local(
        probs.sum(0) / T, mesh,
        [Partial() if j in tok_dims else Replicate() for j in range(n)],
        run_check=False))
    ce = F.one_hot(gate_idx[:, 0], E).to(torch.float32).mean(0)
    aux = m.router_aux_coef * E * torch.sum(me * ce)

    if m.n_shared_experts:
        out = out + module.shared(x)
    return out, DTensor.from_local(aux, mesh, [Replicate()] * n,
                                   run_check=False)
