"""Whisper-style encoder-decoder backbone.

Port of ``repro/models/encdec.py``, in plain PyTorch.  The conv frontend is
a stub in both packages: the caller passes precomputed frame embeddings
(B, S_enc, d) (Whisper's two stride-2 convs are not run).  Encoder:
bidirectional pre-LN blocks with sinusoidal positions.  Decoder: causal
self-attention + cross-attention with learned positions (``dec_pos``, tiled
past ``max_target_len`` in ``decode_train``), GeLU MLPs, LayerNorm; the
output head is tied to ``embed``.  No attention here applies RoPE.

Decode carries a self-attention cache (written in place) plus cross K/V,
computed once from the encoder output by ``encdec_prefill``.  The
reference's layer scans are Python loops over ``enc_blocks`` and
``dec_blocks``, each block checkpointed under ``remat`` while autograd
records.  ``encdec_loss`` is the training loss; ``encode`` and
``decode_train`` are differentiable, the serving calls run under
``torch.no_grad()``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..dist.sharding import summed
from .attention import Attention, decode_kv_heads, init_cache
from .common import (Norm, draw_weights, dtype_of, lookup, matmul, recompute,
                     sinusoidal_positions, softmax_cross_entropy)
from .config import ModelConfig
from .mlp import MLP
from .transformer import check_carry


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``: the reference's
    ``_enc_block_init``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.ln1 = Norm(cfg, dtype=dt, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, dtype=dt, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, *, q_chunk, kv_chunk):
        h, _ = self.attn(self.ln1(x), positions, causal=False,
                         q_chunk=q_chunk, kv_chunk=kv_chunk, use_rope=False)
        # each row-split product's Partial output is summed before the
        # residual add (``summed``): the next products, and the prefill's
        # cross ``wk``/``wv`` on ``enc_out``, take the rank's own columns
        x = x + summed(h)
        return x + summed(self.mlp(self.ln2(x)))


class DecBlock(nn.Module):
    """``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``mlp``:
    the reference's ``_dec_block_init``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.ln1 = Norm(cfg, dtype=dt, device=device)
        self.self_attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, dtype=dt, device=device)
        self.cross_attn = Attention(cfg, device=device)
        self.ln3 = Norm(cfg, dtype=dt, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, enc_out, *, q_chunk, kv_chunk):
        h, _ = self.self_attn(self.ln1(x), positions, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, use_rope=False)
        # each row-split product's Partial output is summed before the
        # residual add (``summed``), as ``EncBlock`` does
        y = x + summed(h)
        # a float32 enc_out promotes a bfloat16 decoder's residual here
        h, _ = self.cross_attn(self.ln2(y), positions, causal=False,
                               xkv=enc_out, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
        y = y + summed(h)
        return y + summed(self.mlp(self.ln3(y)))


class EncDec(nn.Module):
    """``embed`` (V, d), ``dec_pos`` (max_target_len, d), ``enc_blocks``,
    ``dec_blocks``, ``enc_norm``, ``dec_norm``: the reference's
    ``init_encdec``.  Weights are allocated, not drawn: ``init_encdec``
    draws them, ``carry.params_from_reference`` copies them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: the {cfg.family!r} family is not "
                             f"an encoder-decoder")
        self.cfg = cfg
        kw = dict(dtype=dtype_of(cfg.dtype), device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.dec_pos = nn.Parameter(torch.empty(cfg.max_target_len,
                                                cfg.d_model, **kw))
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device=device)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device=device)
                                        for _ in range(cfg.n_dec_layers))
        self.enc_norm = Norm(cfg, dtype=kw["dtype"], device=device)
        self.dec_norm = Norm(cfg, dtype=kw["dtype"], device=device)

    def head(self, x):
        return matmul(x, self.embed.T)  # whisper ties the output head


def _check_model(cfg: ModelConfig, model: EncDec):
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name} "
                         f"({model.cfg}), not for {cfg}")


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def init_encdec(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> EncDec:
    """The model with weights drawn from ``generator`` at the reference's
    scales (``embed`` and ``dec_pos`` at 0.02, matrices at ``d_in **
    -0.5``); biases zero, norm weights one."""
    return draw_weights(EncDec(cfg, device=device), generator)


def encode(cfg: ModelConfig, model: EncDec, frames, *, q_chunk=512,
           kv_chunk=1024, remat=True):
    """frames: (B, S_enc, d) stubbed frame embeddings -> (B, S_enc, d)."""
    _check_model(cfg, model)
    B, S, d = frames.shape
    pos = sinusoidal_positions(S, d).to(device=frames.device,
                                        dtype=frames.dtype)
    x = frames.to(dtype_of(cfg.dtype)) + pos
    positions = _positions(B, S, frames.device)
    for blk in model.enc_blocks:
        x = recompute(blk, x, positions, q_chunk=q_chunk, kv_chunk=kv_chunk,
                      remat=remat)
    return model.enc_norm(x)


def decode_train(cfg: ModelConfig, model: EncDec, tokens, enc_out, *,
                 q_chunk=512, kv_chunk=1024, remat=True):
    """Teacher-forced decoder pass. tokens: (B, S_dec). Returns logits."""
    _check_model(cfg, model)
    B, S = tokens.shape
    pos_table = model.dec_pos
    if S > pos_table.shape[0]:  # tile learned positions for long-form shapes
        pos_table = pos_table.repeat(-(-S // pos_table.shape[0]), 1)
    x = lookup(model.embed, tokens) + pos_table[:S]
    positions = _positions(B, S, x.device)
    for i, blk in enumerate(model.dec_blocks):
        y = recompute(blk, x, positions, enc_out, q_chunk=q_chunk,
                      kv_chunk=kv_chunk, remat=remat)
        check_carry(x, y, f"decoder layer {i}")
        x = y
    return model.head(model.dec_norm(x))


def encdec_loss(cfg: ModelConfig, model: EncDec, batch: dict, **kw):
    """Teacher-forced cross entropy of ``batch`` (``frames``, ``tokens``,
    ``labels``, optional ``loss_mask``); ``kw`` goes to ``encode`` and
    ``decode_train``."""
    enc_out = encode(cfg, model, batch["frames"], **kw)
    logits = decode_train(cfg, model, batch["tokens"], enc_out, **kw)
    return softmax_cross_entropy(logits, batch["labels"],
                                 batch.get("loss_mask"))


# -- serving ------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch, max_self_len, max_cross_len,
                      dtype, *, device=None):
    """``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each (L_dec, B,
    length, nkv, hd)."""
    L = cfg.n_dec_layers
    cache = {}
    for name, length in (("self", max_self_len), ("cross", max_cross_len)):
        c = init_cache(cfg, batch, length, dtype, device=device)
        cache[name] = {k: t[None].repeat((L,) + (1,) * t.ndim)
                       for k, t in c.items()}
    return cache


@torch.no_grad()
def encdec_prefill(cfg: ModelConfig, model: EncDec, frames, cache, *,
                   q_chunk=512, kv_chunk=1024):
    """Run the encoder and compute each decoder layer's cross K/V (``wk``
    and ``wv`` only, no bias), cast to the cross cache's dtype.  As in the
    reference, the returned cache's ``cross`` holds the encoder's length,
    whatever ``max_cross_len`` was.  Returns (cache, enc_out)."""
    enc_out = encode(cfg, model, frames, q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, S = enc_out.shape[:2]
    cross = {}
    for name in ("k", "v"):
        cross[name] = torch.stack([
            matmul(enc_out, getattr(blk.cross_attn, "w" + name)).reshape(
                B, S, cfg.n_kv_heads, cfg.hd())
            for blk in model.dec_blocks]).to(cache["cross"][name].dtype)
    return dict(cache, cross=cross), enc_out


@torch.no_grad()
def encdec_decode_step(cfg: ModelConfig, model: EncDec, token, cache, pos):
    """One decoder token. token (B, 1); pos a scalar (``dec_pos`` row
    ``pos % max_target_len``).  Writes the self cache in place; returns
    (logits, cache)."""
    _check_model(cfg, model)
    B = token.shape[0]
    hd, nq, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    g = nq // nkv
    pos = torch.as_tensor(pos, device=token.device)
    pos_emb = lookup(model.dec_pos, pos % model.dec_pos.shape[0])[None]  # (1, d)
    x = lookup(model.embed, token) + pos_emb
    for i, blk in enumerate(model.dec_blocks):
        sc = {k: t[i] for k, t in cache["self"].items()}
        ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
        h, _ = blk.self_attn.decode(blk.ln1(x), sc, pos, rope=False)
        y = x + h
        # cross-attention against the precomputed K/V (no update, no rope,
        # no mask)
        q = matmul(blk.ln2(y), blk.cross_attn.wq).reshape(B, nkv, g, hd) \
            * hd ** -0.5
        o = decode_kv_heads(q, ck, cv)
        y = y + matmul(o, blk.cross_attn.wo)
        y = y + blk.mlp(blk.ln3(y))
        check_carry(x, y, f"decoder layer {i}")
        x = y
    return model.head(model.dec_norm(x)), cache
