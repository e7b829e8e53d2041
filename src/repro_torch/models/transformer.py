"""Decoder-only LM assembly for the dense, VLM and MoE families.

Port of ``repro/models/transformer.py``.  The model is an ``LM`` module
holding ``nn.ModuleList``s of ``Block``s (norms, attention, and an MLP or
an MoE); the reference's functional names (``init_lm``, ``lm_forward``,
``init_lm_cache``, ``lm_decode_step``, ``lm_prefill``) are thin functions
over it.  Parameters keep the reference's names and ``(d_in, d_out)``
layouts: the reference's stacked ``blocks/attn/wq[l]`` is the port's
``blocks.{l}.attn.wq`` (``carry.py`` converts between the two).

DeepSeekMoE's leading dense layers are ``dense_blocks``, the MoE layers
after them ``blocks``; both share one KV cache, the dense layers its
leading ``first_dense_layers`` slices.

The reference scans its layers under remat; the port runs them in a Python
loop, eagerly.  The VLM's image frontend is a stub in both: precomputed
patch embeddings are prepended to the text tokens.  The SSM, hybrid and
enc-dec families are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from .common import Norm, draw_weights, dtype_of, matmul
from .config import ModelConfig
from .mlp import MLP
from .moe import MoE

# Where each family not served by the dense block waits (ROADMAP.md, Queue 1).
PENDING = {
    "ssm": "item 12b, models/ssm.py",
    "hybrid": "item 12c, the zamba2 hybrid",
    "encdec": "item 12d, models/encdec.py",
}
PORTED = ("dense", "vlm", "moe")


def check_family(cfg: ModelConfig):
    """Raise unless the port has ``cfg``'s family."""
    if cfg.family in PORTED:
        return
    if cfg.family in PENDING:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, Queue 1 {PENDING[cfg.family]})")
    raise ValueError(cfg.family)


class Block(nn.Module):
    """One pre-norm transformer block: ``ln1``, ``attn``, ``ln2``, and
    ``mlp`` (hidden size ``d_ff``, default ``cfg.d_ff``) or, with
    ``moe=True``, ``moe``."""

    def __init__(self, cfg: ModelConfig, *, moe: bool = False,
                 d_ff: int | None = None, device=None):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.ln1 = Norm(cfg, dtype=dt, device=device)
        self.attn = attn_mod.Attention(cfg, device=device)
        self.ln2 = Norm(cfg, dtype=dt, device=device)
        if moe:
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = MLP(cfg, d_ff, device=device)

    def _ffn(self, x):
        """The residual after the MLP or MoE, and the MoE's aux loss (None
        for an MLP)."""
        if hasattr(self, "mlp"):
            return x + self.mlp(self.ln2(x)), None
        out, aux = self.moe(self.ln2(x))
        return x + out, aux

    def forward(self, x, positions, *, q_chunk, kv_chunk, cache=None):
        """The reference's ``_dense_block_fwd``: returns (x, aux).  With
        ``cache`` (this layer's k/v, batch-first) the block's k/v are
        written into it from position 0, as ``lm_prefill``'s scan body
        does."""
        h, (k, v) = self.attn(self.ln1(x), positions, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
        if cache is not None:
            attn_mod._update_slice(cache["k"], k, 0)
            attn_mod._update_slice(cache["v"], v, 0)
        return self._ffn(x + h)

    def decode(self, x, cache, pos):
        h, _ = self.attn.decode(self.ln1(x), cache, pos)
        return self._ffn(x + h)[0]


class LM(nn.Module):
    """``embed`` (V, d), for DeepSeekMoE ``dense_blocks`` (its
    ``first_dense_layers`` dense layers of hidden size ``d_ff_dense``),
    ``blocks``, ``final_norm`` and, untied, ``lm_head`` (d, V).  Weights
    are allocated, not drawn: ``init_lm`` draws them,
    ``carry.params_from_reference`` copies them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        dt = dtype_of(cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                              dtype=dt, device=device))
        moe = cfg.family == "moe"
        nd = cfg.moe.first_dense_layers if moe else 0
        if nd:
            self.dense_blocks = nn.ModuleList(
                Block(cfg, d_ff=cfg.moe.d_ff_dense or cfg.d_ff, device=device)
                for _ in range(nd))
        self.blocks = nn.ModuleList(Block(cfg, moe=moe, device=device)
                                    for _ in range(cfg.n_layers - nd))
        self.final_norm = Norm(cfg, dtype=dt, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab,
                                                    dtype=dt, device=device))

    def _inputs(self, tokens, patch_embeds):
        x = self.embed[tokens.long()]
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        return x, positions

    def _head(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return matmul(x, head)

    def layers(self):
        """Every block in cache order: the dense-first ones, then the rest."""
        return [*getattr(self, "dense_blocks", ()), *self.blocks]

    def forward(self, tokens, *, patch_embeds=None, q_chunk=512,
                kv_chunk=1024, logits_mode="all"):
        x, positions = self._inputs(tokens, patch_embeds)
        auxs = []
        for blk in self.layers():
            x, aux = blk(x, positions, q_chunk=q_chunk, kv_chunk=kv_chunk)
            if aux is not None:
                auxs.append(aux)
        # the MoE layers' summed aux loss (the dense-first layers add none)
        aux = (torch.stack(auxs).sum() if auxs else
               torch.zeros((), dtype=torch.float32, device=x.device))
        x = self.final_norm(x)
        if logits_mode == "none":
            return x, aux
        if logits_mode == "last":
            x = x[:, -1:]
        return self._head(x), aux

    def prefill(self, tokens, cache, *, patch_embeds=None, q_chunk=512,
                kv_chunk=1024):
        x, positions = self._inputs(tokens, patch_embeds)
        ck = cache["attn"]
        for i, blk in enumerate(self.layers()):
            x, _ = blk(x, positions, q_chunk=q_chunk, kv_chunk=kv_chunk,
                       cache={"k": ck["k"][i], "v": ck["v"][i]})
        x = self.final_norm(x[:, -1:])
        return self._head(x), cache

    def decode_step(self, token, cache, pos):
        x = self.embed[token.long()]
        ck = cache["attn"]
        for i, blk in enumerate(self.layers()):
            y = blk.decode(x, {"k": ck["k"][i], "v": ck["v"][i]}, pos)
            if y.dtype != x.dtype:
                # The reference scans the layers with x as the carry and
                # rejects a body that changes its type (a bfloat16 model
                # over a float32 cache promotes the residual).
                raise TypeError(
                    f"the layer's output residual is {y.dtype}, its input "
                    f"{x.dtype}: the reference's layer scan rejects this "
                    f"carry (a {x.dtype} model decoding against a "
                    f"{ck['k'].dtype} cache)")
            x = y
        x = self.final_norm(x)
        return self._head(x), cache


def _check_model(cfg: ModelConfig, model: LM):
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name} "
                         f"({model.cfg}), not for {cfg}")


# -- init ---------------------------------------------------------------------


def init_lm(cfg: ModelConfig, generator: torch.Generator, *,
            device=None) -> LM:
    """The model with weights drawn from ``generator``: truncated normals,
    the embedding at scale 0.02 and every matrix (stacked expert weights
    too) at ``d_in ** -0.5``, as the reference draws them (its random
    stream is JAX's and is not reproduced); biases zero, norm weights
    one.  The MoE router stays float32 in every config."""
    return draw_weights(LM(cfg, device=device), generator)


# -- forward passes -----------------------------------------------------------


def lm_forward(cfg: ModelConfig, model: LM, tokens, *, patch_embeds=None,
               q_chunk=512, kv_chunk=1024, logits_mode="all"):
    """tokens: (B, S) int.  VLM: patch_embeds (B, n_img, d) prepended.

    logits_mode: 'all' (training) | 'last' (prefill) | 'none' (returns hidden).
    Returns (logits_or_hidden, aux_loss)."""
    _check_model(cfg, model)
    return model(tokens, patch_embeds=patch_embeds, q_chunk=q_chunk,
                 kv_chunk=kv_chunk, logits_mode=logits_mode)


# -- serving ------------------------------------------------------------------


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                  device=None):
    """Decode cache: ``{"attn": {"k", "v"}}``, each (L, B, max_len, nkv, hd)."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd())
    return {"attn": {k: torch.zeros(shape, dtype=dtype, device=device)
                     for k in ("k", "v")}}


@torch.no_grad()
def lm_decode_step(cfg: ModelConfig, model: LM, token, cache, pos):
    """token: (B, 1) int; pos: scalar, or (B,) per slot.  Writes the cache
    in place; returns (logits, cache)."""
    _check_model(cfg, model)
    return model.decode_step(token, cache, pos)


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, model: LM, tokens, cache, *,
               patch_embeds=None, q_chunk=512, kv_chunk=1024):
    """Prefill: run the full sequence, write each layer's k/v into the
    cache from position 0 (in place), return last-token logits."""
    _check_model(cfg, model)
    return model.prefill(tokens, cache, patch_embeds=patch_embeds,
                         q_chunk=q_chunk, kv_chunk=kv_chunk)
