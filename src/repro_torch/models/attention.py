"""GQA attention with RoPE, chunked (flash-style) prefill and KV-cache decode.

Port of ``repro/models/attention.py``, in plain PyTorch.  Prefill never
materializes the full (S, S) score matrix: an online softmax runs over KV
chunks, one query chunk at a time, with the reference's arithmetic and its
chunk sizes (``_chunked_attention``), and keeps no per-chunk scores for the
backward pass.  Decode computes one-step attention
against the cache.

Cache writes keep the reference's rules for positions out of range: a
per-slot write (``.at[rows, pos].set``) drops the row, a scalar write
(``dynamic_update_slice``) clamps its start into the cache.  The cache is
written in place and returned.
"""
from __future__ import annotations

import torch
from torch import nn

from torch.distributed.tensor import DTensor

from ..dist.sharding import (batch_only, constrain, grad_whole_dim,
                             local_write, on_local_shards, split_q_heads,
                             whole_dim)
from .common import apply_rope, dtype_of, einsum, matmul, recompute

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (and ``bq``, ``bk``, ``bv`` with
    ``cfg.qkv_bias``): the reference's ``init_attention``; ``forward`` is
    its ``attention`` and ``decode`` its ``decode_attention``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.hd()
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        kw = dict(dtype=dtype_of(cfg.dtype), device=device)
        self.wq = nn.Parameter(torch.empty(d, nq * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, nkv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, nkv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(nq * hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(nq * hd, **kw))
            self.bk = nn.Parameter(torch.zeros(nkv * hd, **kw))
            self.bv = nn.Parameter(torch.zeros(nkv * hd, **kw))

    def project_qkv(self, x, xkv=None):
        cfg = self.cfg
        B, S, _ = x.shape
        hd, nq, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
        xkv = x if xkv is None else xkv
        q = matmul(x, self.wq)
        k = matmul(xkv, self.wk)
        v = matmul(xkv, self.wv)
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        # a DTensor's head dimension must split into whole heads
        # (``whole_dim``: gathered on a mesh axis that does not divide them)
        q = whole_dim(q, -1, nq).reshape(B, S, nq, hd)
        k = whole_dim(k, -1, nkv).reshape(B, xkv.shape[1], nkv, hd)
        v = whole_dim(v, -1, nkv).reshape(B, xkv.shape[1], nkv, hd)
        return q, k, v

    def forward(self, x, positions, *, causal=True, xkv=None, q_chunk=512,
                kv_chunk=1024, use_rope=True, q_spec=None, kv_spec=None):
        """Full-sequence attention (train / prefill / encoder / cross with
        ``xkv``).  Returns ``(out, (k, v))``.

        ``q_spec``/``kv_spec`` (``dist.sharding.NamedSharding``s of the 4-D
        (B, S, H, hd) DTensors) pin the GQA layout when ``n_kv_heads`` does
        not divide the model axis: q and k/v are redistributed to them, the
        reference's sharding constraints."""
        q, k, v = self.project_qkv(x, xkv)
        if q_spec is not None:
            q = constrain(q, q_spec)
        if kv_spec is not None:
            k, v = constrain(k, kv_spec), constrain(v, kv_spec)
        if xkv is None and use_rope:  # self-attention: rope both
            q = apply_rope(q, positions, self.cfg.rope_theta)
            k = apply_rope(k, positions, self.cfg.rope_theta)
        out = _chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
        B, S = x.shape[:2]
        # heads split unevenly over the model axis are gathered before they
        # flatten into ``wo``'s rows (``whole_dim``); the gradient from
        # ``wo`` splits back into whole heads (``grad_whole_dim``)
        out = whole_dim(out, 2, self.cfg.n_heads).reshape(B, S, -1)
        out = grad_whole_dim(out, -1, self.cfg.n_heads)
        return matmul(out, self.wo), (k, v)

    def decode(self, x, cache, pos, *, rope: bool = True):
        """One-token decode. x: (B, 1, d); cache k/v: (B, Smax, nkv, hd);
        pos: scalar, or (B,) for per-slot positions (continuous batching).
        Returns (out, cache)."""
        cfg = self.cfg
        B = x.shape[0]
        hd, nq, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
        g = nq // nkv
        pos = torch.as_tensor(pos, device=x.device)
        per_slot = pos.ndim == 1
        # the products take the local columns of ``wq``/``wk``/``wv``
        # (DTensor would gather ``wk``/``wv`` to meet a Partial ``x``, or
        # split the contraction and leave q Partial), so that q and the
        # new k/v split on their heads as the cache does
        x = batch_only(x)
        q, k, v = self.project_qkv(x)
        if rope:
            pp = (pos[:, None] if per_slot else pos.expand(B, 1)).to(torch.int32)
            q = apply_rope(q, pp, cfg.rope_theta)
            k = apply_rope(k, pp, cfg.rope_theta)
        for name, new in (("k", k), ("v", v)):
            if per_slot:
                _scatter_rows(cache[name], pos, new[:, 0])
            else:
                _update_slice(cache[name], new, pos)
        q, by_q_head = split_q_heads(q, 2, nkv)
        if by_q_head:
            # each rank scores its own q heads against the kv heads they
            # read (the cache whole on the model axis)
            out = on_local_shards(
                _decode_q_heads, (q * hd ** -0.5, cache["k"], cache["v"]),
                ({"batch": 0, "qheads": 2}, {"batch": 0}, {"batch": 0}),
                {"batch": B, "qheads": nq}, {"batch": 0, "qheads": 2},
                offsets=("qheads",), uneven=("qheads",), bound=pos, group=g)
            out = whole_dim(out, 2, nq).reshape(B, 1, nq * hd)
            return matmul(out, self.wo), cache
        qh = (whole_dim(q, 2, nkv) * hd ** -0.5).reshape(B, nkv, g, hd)
        bound = pos[:, None, None, None] if per_slot else pos
        out = decode_kv_heads(qh, cache["k"], cache["v"], bound)
        return matmul(out, self.wo), cache


def decode_kv_heads(qh, k, v, bound=None):
    """One-token attention of q (B, nkv, g, hd), scaled, against the
    cache k/v (B, S, nkv, hd), keys past ``bound`` masked (None: none)
    -> (B, 1, nkv * g * hd).  DTensors run on local shards, split by
    batch and kv heads (a DTensor einsum would flatten the batch with a
    split kv-head dimension, which torch 2.11 rejects); a Partial q (the
    cross attention's, after a residual left Partial) is reduced first,
    as ``on_local_shards`` would gather the cache to meet it."""
    return on_local_shards(
        _decode_kv_heads, (batch_only(qh), k, v),
        ({"batch": 0, "heads": 1}, {"batch": 0, "heads": 2},
         {"batch": 0, "heads": 2}),
        {"batch": qh.shape[0], "heads": qh.shape[1]},
        {"batch": 0, "heads": 2}, bound=bound)


def _decode_kv_heads(qh, k, v, *, bound):
    """``decode_kv_heads`` on plain tensors."""
    s = einsum("bkgh,bskh->bkgs", qh, k).to(torch.float32)
    if bound is not None:
        kv_pos = torch.arange(k.shape[1], device=qh.device)
        s = torch.where(kv_pos[None, None, None, :] <= bound, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = einsum("bkgs,bskh->bkgh", w.to(v.dtype), v)
    return out.reshape(out.shape[0], 1, -1)


def _kv_runs(h0: int, n: int, group: int) -> list:
    """The q heads [h0, h0 + n) in runs that read one kv head (head h reads
    h // group): (kv head, first, end), first and end counted from h0."""
    runs, h = [], h0
    while h < h0 + n:
        end = min(h0 + n, (h // group + 1) * group)
        runs.append((h // group, h - h0, end - h0))
        h = end
    return runs


def _decode_q_heads(q, k, v, *, bound, group: int, qheads0: int):
    """One-token attention of a rank's q heads [qheads0, qheads0 + n), q
    (B, 1, n, hd) scaled, against the whole cache k/v (B, S, nkv, hd):
    each run of heads against the kv head it reads, keys past ``bound``
    masked -> (B, 1, n, hd)."""
    kv_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for j, a, b in _kv_runs(qheads0, q.shape[2], group):
        s = einsum("bgh,bsh->bgs", q[:, 0, a:b], k[:, :, j]).to(torch.float32)
        w = torch.softmax(torch.where(kv_pos <= bound, s, NEG_INF), dim=-1)
        outs.append(einsum("bgs,bsh->bgh", w.to(v.dtype), v[:, :, j]))
    if not outs:  # a rank past the last head
        return q.new_zeros(q.shape, dtype=v.dtype)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, 1))[:, None]


def _scatter_rows(buf, pos, rows):
    """``buf.at[arange(B), pos].set(rows)`` with JAX's rules: a negative
    position counts from the end, and a row whose position is still out of
    range is dropped.  No host synchronization."""
    S = buf.shape[1]
    idx = pos.long()
    idx = torch.where(idx < 0, idx + S, idx)
    keep = (idx >= 0) & (idx < S)
    safe = idx.clamp(0, S - 1)
    if isinstance(buf, DTensor):
        raise NotImplementedError(
            "per-slot positions over a sharded cache: the sharded serving "
            "steps decode at one position")
    b = torch.arange(buf.shape[0], device=buf.device)
    buf[b, safe] = torch.where(keep[:, None, None], rows.to(buf.dtype),
                               buf[b, safe])


def _update_slice(buf, new, start):
    """``dynamic_update_slice(buf, new, (0, start, 0, 0))``: the start is
    clamped so that the whole update lies inside ``buf``."""
    n = new.shape[1]
    if n > buf.shape[1]:
        raise ValueError(f"update of {n} positions into a cache of "
                         f"{buf.shape[1]}")
    first = torch.clamp(torch.as_tensor(start, device=buf.device),
                        0, buf.shape[1] - n)
    idx = first.long().reshape(1) + torch.arange(n, device=buf.device)
    # a DTensor cache is written shard by shard (``local_write``)
    buf, new = local_write(buf, new)
    buf.index_copy_(1, idx, new.to(buf.dtype))


def _chunk_count(n: int, chunk: int) -> int:
    """The reference's chunking: above ``chunk``, ``n // chunk`` chunks of
    ``n // (n // chunk)`` each.  Its reshape fails where they do not tile
    ``n``; so does this (the port pads nothing)."""
    count = max(1, n // max(chunk, 1)) if n > chunk else 1
    if n % count:
        raise ValueError(
            f"sequence of {n} does not split into {count} chunks of "
            f"{n // count} (chunk size {chunk}); the reference's reshape "
            f"rejects this shape too")
    return count


def _kv_step(qc, q_pos, kc, vc, ki, kv_chunk, causal, m, l, acc):
    """One KV chunk of the online softmax: (m, l, acc) updated by the
    scores of ``qc`` against ``kc``."""
    s = einsum("bqkgh,bskh->bkgqs", qc, kc).to(torch.float32)
    if causal:
        kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=qc.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    pexp = torch.exp(s - m_new[..., None])
    l = l * alpha + pexp.sum(-1)
    acc = acc * alpha[..., None] + einsum(
        "bkgqs,bskh->bkgqh", pexp.to(vc.dtype), vc
    ).to(torch.float32)
    return m_new, l, acc


def live_kv_chunks(qi, q_chunk, kv_chunk, nkc, causal) -> int:
    """How many leading KV chunks query chunk ``qi`` attends to: all of
    them, or under the causal mask those that start at or before its last
    query.  A chunk past that is masked whole: its scores are ``NEG_INF``
    after a chunk with a live key (chunk 0 always has one), so it leaves
    ``m`` and ``l`` as they were (``alpha`` = exp(0) = 1, ``pexp`` = 0) and
    adds exact zeros to ``acc``; skipping it changes no value and no
    gradient."""
    if not causal:
        return nkc
    return min(nkc, (qi * q_chunk + q_chunk - 1) // kv_chunk + 1)


def _per_q_chunk(qc, k_ch, v_ch, qi, q_chunk, rows0, causal):
    """Rows ``rows0`` onward of query chunk ``qi`` (of ``q_chunk`` rows)
    against every KV chunk it attends to -> the online softmax's
    (acc (B, nkv, g, rows, hd), l (B, nkv, g, rows)), l clamped here (a
    checkpoint of this function recomputes its last KV step to give the
    clamp its input back, as it did when the division was here too)."""
    B, rows, nkv, g, hd = qc.shape
    kv_chunk = k_ch.shape[2]
    dev = qc.device
    q_pos = qi * q_chunk + rows0 + torch.arange(rows, device=dev)
    m = torch.full((B, nkv, g, rows), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nkv, g, rows), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nkv, g, rows, hd), dtype=torch.float32,
                      device=dev)
    for ki in range(live_kv_chunks(qi, q_chunk, kv_chunk, k_ch.shape[1],
                                   causal)):
        m, l, acc = recompute(_kv_step, qc, q_pos, k_ch[:, ki], v_ch[:, ki],
                              ki, kv_chunk, causal, m, l, acc)
    return acc, torch.clamp_min(l, 1e-30)


def _chunked_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int):
    """Online-softmax attention. q: (B,Sq,nq,hd), k/v: (B,Skv,nkv,hd).

    q is split into (B, chunks, rows, nq, hd) and the chunk loops run on
    plain tensors (``_attend``).  DTensors are laid out once and the
    loops run on each rank's local shards (``dist.sharding.
    on_local_shards``): batch, whole kv-head groups, q's own heads (where
    the model axis cannot split whole groups; k/v whole there) and the
    rows of every q chunk may stay split (the rows where Partial operands
    split neither of the others, as DTensor's own choice splits them); the
    chunks of a
    split sequence are gathered once, as the KV loop reads all of k and v
    and the causal mask global positions.  Without this DTensor would lay
    out every operator of every KV step anew."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    nqc = _chunk_count(Sq, q_chunk)
    q_chunk = Sq // nqc
    # a DTensor's sequence splits into chunks along whole shards
    # (``whole_dim``)
    q = whole_dim(q, 1, nqc).reshape(B, nqc, q_chunk, nq, hd)
    # a q split on its heads where the model axis cannot split whole
    # kv-head groups (the GQA pinning; sequence parallelism where the heads
    # divide the axis): each rank runs its own q heads against the kv
    # heads they read.  A replicated q (heads that do not divide the axis)
    # is split on its heads too, its gradient each rank's Partial share
    q, by_q_head = split_q_heads(q, 3, nkv)
    if by_q_head:
        qd, kd = {"batch": 0, "qheads": 3, "rows": 2}, {"batch": 0}
        ad = {"batch": 0, "qheads": 2, "rows": 3}
        sizes = {"batch": B, "qheads": nq, "rows": q_chunk}
        kw = dict(offsets=("rows", "qheads"), uneven=("qheads",),
                  group=nq // nkv)
    else:
        qd, kd = {"batch": 0, "heads": 3, "rows": 2}, {"batch": 0, "heads": 2}
        ad = {"batch": 0, "heads": 2, "rows": 4}
        sizes = {"batch": B, "heads": nkv, "rows": q_chunk}
        kw = dict(offsets=("rows",))
    acc, l = on_local_shards(_attend, (q, k, v), (qd, kd, kd), sizes,
                             (ad, ad), causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, **kw)
    # the division after the loops, by DTensor's operators: a Partial
    # gradient from the output projection is summed after its backward,
    # as when the loops ran on DTensors; the rows gathered once
    out = acc / l[..., None]
    out = (out.permute(0, 1, 3, 2, 4) if by_q_head
           else out.permute(0, 1, 4, 2, 3, 5))
    out = whole_dim(out.reshape(B, nqc, q_chunk, nq, hd), 2)
    out = out.reshape(B, Sq, nq, hd)
    if not by_q_head:
        # the gradient splits back into (nkv, g) along whole shards
        # (``grad_whole_dim``)
        out = grad_whole_dim(out, 2, nkv)
    return out.to(v.dtype)


def _attend(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
            rows0: int, qheads0=None, group: int = 1):
    """``_chunked_attention``'s loops on plain tensors: q (B, nqc, rows,
    nq, hd), rows ``rows0`` onward of each chunk of ``q_chunk``; returns
    the online softmax's acc (B, nqc, nkv, g, rows, hd) and l (B, nqc,
    nkv, g, rows), which ``_chunked_attention`` divides.

    GQA handled by reshaping q to (..., nkv, g, hd).  Runs KV chunks with
    running (max, denom, acc), one q chunk at a time, and under the causal
    mask only the chunks it does not mask whole (``live_kv_chunks``: the
    values are the reference's, which computes those too).  While autograd
    records, each q chunk and each KV step inside it is checkpointed, as
    the reference checkpoints ``per_q_chunk`` and ``kv_step``: the
    backward pass recomputes every (q, kv) chunk pair's scores instead of
    keeping them.

    With ``qheads0`` q holds a rank's own q heads [qheads0, qheads0 + n)
    (``split_q_heads``) and k/v every kv head: each run of q heads that
    read one kv head (head h reads h // ``group``) runs against it alone,
    and acc (B, nqc, n, rows, hd) and l (B, nqc, n, rows) come per q
    head.  A rank past the last head runs none against kv head 0, so that
    its gradients take part in the backward's collectives.
    """
    if qheads0 is not None:
        B, nqc, rows, n, hd = q.shape
        runs = _kv_runs(qheads0, n, group) or [(0, 0, 0)]
        parts = [_attend(q[:, :, :, a:b], k[:, :, j:j + 1], v[:, :, j:j + 1],
                         causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                         rows0=rows0) for j, a, b in runs]
        acc, l = ([t.flatten(2, 3) for t in ts] for ts in zip(*parts))
        if len(parts) == 1:
            return acc[0], l[0]
        return torch.cat(acc, 2), torch.cat(l, 2)
    B, nqc, rows, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5
    nkc = _chunk_count(Skv, kv_chunk)
    kv_chunk = Skv // nkc

    q_ch = (q * scale).reshape(B, nqc, rows, nkv, g, hd)
    k_ch = k.reshape(B, nkc, kv_chunk, nkv, hd)
    v_ch = v.reshape(B, nkc, kv_chunk, nkv, hd)
    outs = [recompute(_per_q_chunk, q_ch[:, qi], k_ch, v_ch, qi, q_chunk,
                      rows0, causal) for qi in range(nqc)]
    return (torch.stack([a for a, _ in outs], dim=1),
            torch.stack([l for _, l in outs], dim=1))


def init_cache(cfg, batch, max_len, dtype, *, device=None):
    hd, nkv = cfg.hd(), cfg.n_kv_heads
    return {
        "k": torch.zeros((batch, max_len, nkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, nkv, hd), dtype=dtype, device=device),
    }
