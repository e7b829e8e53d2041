"""Decoder-only LM assembly for the dense, VLM, MoE, SSM and hybrid families.

Port of ``repro/models/transformer.py``.  The model is an ``LM`` module
holding ``nn.ModuleList``s of blocks: ``Block``s (norms, attention, and an
MLP or an MoE) or ``SSMBlock``s (a norm and a Mamba mixer); the
reference's functional names (``init_lm``, ``lm_forward``,
``init_lm_cache``, ``lm_decode_step``, ``lm_prefill``) are thin functions
over it.  Parameters keep the reference's names and ``(d_in, d_out)``
layouts: the reference's stacked ``blocks/attn/wq[l]`` is the port's
``blocks.{l}.attn.wq`` (``carry.py`` converts between the two).

DeepSeekMoE's leading dense layers are ``dense_blocks``, the MoE layers
after them ``blocks``; both share one KV cache, the dense layers its
leading ``first_dense_layers`` slices.  The zamba2 hybrid holds one dense
``shared_attn`` block, called after the *first* mamba block of each group
of ``attn_every`` (and of the tail), with its own KV cache slice per call
site (``hybrid_schedule``).

The reference scans its layers under remat; the port runs them in a Python
loop, eagerly, and with ``remat`` (training, while autograd records)
checkpoints each block with ``torch.utils.checkpoint``: a block keeps only
its input and recomputes the rest in the backward pass.  ``lm_loss`` is
the reference's training loss.  The VLM's image frontend is a stub in both: precomputed
patch embeddings are prepended to the text tokens.  The enc-dec family is
``encdec.py``'s.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..dist.sharding import (grad_like, local_write, on_own_rows, own_rows,
                             splits_rows, summed, whole_dim)
from . import attention as attn_mod
from . import ssm as ssm_mod
from .common import (Norm, draw_weights, dtype_of, lookup, matmul,
                     recompute, softmax_cross_entropy)
from .config import ModelConfig
from .mlp import MLP
from .moe import MoE

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")  # the LM's; not encdec


def check_family(cfg: ModelConfig):
    """Raise unless ``cfg`` is a decoder-only LM (enc-dec configs are
    ``encdec.py``'s)."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name}: the {cfg.family!r} family is not a decoder-only "
            f"LM" + ("; use models/encdec.py" if cfg.family == "encdec"
                     else ""))


def check_carry(x, y, what):
    """The reference scans its layers with the residual as the carry, and
    rejects a body that changes its type (a bfloat16 model's attention
    over a float32 cache, or over a float32 encoder output, promotes the
    residual)."""
    if y.dtype != x.dtype:
        raise TypeError(
            f"{what}'s output residual is {y.dtype}, its input {x.dtype}: "
            f"the reference's layer scan rejects this carry (a {x.dtype} "
            f"model attending to float32 keys and values)")


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

    def _ffn(self, x, sum_out=False):
        """The residual after the MLP or MoE, and the MoE's aux loss (None
        for an MLP).  With ``sum_out`` the output is ``summed`` first."""
        if hasattr(self, "mlp"):
            out, aux = self.mlp(self.ln2(x)), None
        else:
            out, aux = self.moe(self.ln2(x))
        return x + (summed(out, x) if sum_out else out), aux

    def forward(self, x, positions, *, q_chunk, kv_chunk, cache=None,
                q_spec=None, kv_spec=None):
        """The reference's ``_dense_block_fwd``: returns (x, aux).  With
        ``cache`` (this layer's k/v, batch-first) the block's k/v are
        written into it from position 0, as ``lm_prefill``'s scan body
        does.  ``q_spec``/``kv_spec``: the attention's GQA pinning."""
        h, (k, v) = self.attn(self.ln1(x), positions, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, q_spec=q_spec,
                              kv_spec=kv_spec)
        if cache is not None:
            attn_mod._update_slice(cache["k"], k, 0)
            attn_mod._update_slice(cache["v"], v, 0)
        # the Partial output of each row-split product is summed before the
        # residual add (``summed``), so that the next products, and their
        # weight gradients, take the rank's own columns of their weights
        return self._ffn(x + summed(h, x), sum_out=True)

    def decode(self, x, cache, pos):
        h, _ = self.attn.decode(self.ln1(x), cache, pos)
        return self._ffn(x + h)[0]


class SSMBlock(nn.Module):
    """``ln`` and ``ssm`` (``Mamba1`` or ``Mamba2`` by ``cfg.ssm.version``),
    with no MLP: the reference's ``_init_block(kind="ssm")``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln = Norm(cfg, dtype=dtype_of(cfg.dtype), device=device)
        self.ssm = ssm_mod.mixer(cfg, device=device)

    def forward(self, x, state=None):
        """The reference's ``_ssm_block_fwd``: returns (x, final state)."""
        out, st = ssm_mod.block_fn(self.cfg)(self.cfg, self.ssm, self.ln(x),
                                             state=state)
        # the mixer's row-split output is summed before the residual add
        # (``summed``), as ``Block`` does
        return x + summed(out), st

    def decode(self, x, state):
        out, st = ssm_mod.decode_fn(self.cfg)(self.cfg, self.ssm, self.ln(x),
                                              state)
        return x + summed(out), st


def write(buf, new):
    """``buf.copy_(new)``; a DTensor ``buf`` shard by shard
    (``dist.sharding.local_write``)."""
    buf, new = local_write(buf, new)
    buf.copy_(new)


def hybrid_attn_layers(cfg) -> int:
    """Number of shared-attention call sites in the zamba2-style hybrid."""
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def hybrid_schedule(cfg):
    """The hybrid's layer order, as the reference's ``_hybrid_split``
    groups it: each group of ``attn_every`` mamba blocks (and the tail) is
    ``[mamba, shared_attn, mamba x (rest)]``, the shared block after the
    group's *first* mamba block.  Yields ("ssm", layer) and ("attn", call
    site)."""
    E = cfg.attn_every
    for site, start in enumerate(range(0, cfg.n_layers, E)):
        yield "ssm", start
        yield "attn", site
        for layer in range(start + 1, min(start + E, cfg.n_layers)):
            yield "ssm", layer


class LM(nn.Module):
    """``embed`` (V, d), for DeepSeekMoE ``dense_blocks`` (its
    ``first_dense_layers`` dense layers of hidden size ``d_ff_dense``),
    ``blocks`` (``Block``s, or ``SSMBlock``s for the SSM and hybrid
    families), for the hybrid ``shared_attn`` (one dense ``Block``),
    ``final_norm`` and, untied, ``lm_head`` (d, V).  Weights are
    allocated, not drawn: ``init_lm`` draws them,
    ``carry.params_from_reference`` copies them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        dt = dtype_of(cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                              dtype=dt, device=device))
        if cfg.family in ("ssm", "hybrid"):
            self.blocks = nn.ModuleList(SSMBlock(cfg, device=device)
                                        for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_attn = Block(cfg, device=device)
        else:
            moe = cfg.family == "moe"
            nd = cfg.moe.first_dense_layers if moe else 0
            if nd:
                self.dense_blocks = nn.ModuleList(
                    Block(cfg, d_ff=cfg.moe.d_ff_dense or cfg.d_ff,
                          device=device)
                    for _ in range(nd))
            self.blocks = nn.ModuleList(Block(cfg, moe=moe, device=device)
                                        for _ in range(cfg.n_layers - nd))
        self.final_norm = Norm(cfg, dtype=dt, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab,
                                                    dtype=dt, device=device))

    def _inputs(self, tokens, patch_embeds):
        x = lookup(self.embed, tokens)
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        return x, positions

    def _head(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        j = own_rows(x, head)
        if j is not None:
            # a vocabulary that the model axis does not split: each rank's
            # logits of its own rows (``on_own_rows``)
            return on_own_rows(matmul, x, head, j)
        # the logits' gradient comes back split as they are, on the
        # vocabulary (``grad_like``)
        return grad_like(matmul(x, head))

    def layers(self):
        """Every block in cache order: the dense-first ones, then the rest."""
        return [*getattr(self, "dense_blocks", ()), *self.blocks]

    def _ssm_schedule(self):
        if self.cfg.family == "hybrid":
            return hybrid_schedule(self.cfg)
        return (("ssm", i) for i in range(self.cfg.n_layers))

    def _sequence(self, x, positions, *, q_chunk, kv_chunk, cache=None,
                  remat=False, q_spec=None, kv_spec=None):
        """Every layer over the whole sequence; with ``cache``, the
        attention layers write their k/v from position 0 and the SSM
        layers their final states, cast to the cache's dtype.  With
        ``remat`` each block is checkpointed (``recompute``).  The GQA
        pinning ``q_spec``/``kv_spec`` reaches the dense and MoE blocks
        (not the hybrid's shared block), as in the reference.  Returns
        (x, the MoE layers' aux losses)."""
        kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, remat=remat)
        if self.cfg.family not in ("ssm", "hybrid"):
            auxs = []
            for i, blk in enumerate(self.layers()):
                kv = None if cache is None else {
                    "k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}
                x, aux = recompute(blk, x, positions, cache=kv,
                                   q_spec=q_spec, kv_spec=kv_spec, **kw)
                if aux is not None:
                    auxs.append(aux)
            return x, auxs
        for kind, i in self._ssm_schedule():
            if kind == "attn":
                kv = None if cache is None else {
                    "k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}
                x, _ = recompute(self.shared_attn, x, positions, cache=kv,
                                 **kw)
                continue
            x, st = recompute(self.blocks[i], x, remat=remat)
            if cache is not None:
                for name, t in st.items():
                    write(cache["ssm"][name][i], t)
        return x, []

    def forward(self, tokens, *, patch_embeds=None, q_chunk=512,
                kv_chunk=1024, logits_mode="all", remat=False, q_spec=None,
                kv_spec=None):
        x, positions = self._inputs(tokens, patch_embeds)
        x, auxs = self._sequence(x, positions, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, remat=remat,
                                 q_spec=q_spec, kv_spec=kv_spec)
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
        x, _ = self._sequence(x, positions, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, cache=cache)
        x = self.final_norm(x[:, -1:])
        return self._head(x), cache

    def decode_step(self, token, cache, pos):
        x = lookup(self.embed, token)
        if self.cfg.family in ("ssm", "hybrid"):
            for kind, i in self._ssm_schedule():
                if kind == "attn":
                    ck = cache["attn"]
                    y = self.shared_attn.decode(
                        x, {"k": ck["k"][i], "v": ck["v"][i]}, pos)
                    check_carry(x, y, f"the shared block at call site {i}")
                    x = y
                    continue
                cs = cache["ssm"]
                y, st = self.blocks[i].decode(
                    x, {name: t[i] for name, t in cs.items()})
                check_carry(x, y, f"mamba layer {i}")
                x = y
                for name, t in st.items():
                    write(cs[name][i], t)
        else:
            ck = cache["attn"]
            for i, blk in enumerate(self.layers()):
                y = blk.decode(x, {"k": ck["k"][i], "v": ck["v"][i]}, pos)
                check_carry(x, y, f"layer {i}")
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
    """The model with weights drawn from ``generator``: truncated normals
    at the reference's scales (``common.draw_weights``; its random stream
    is JAX's and is not reproduced); biases zero, norm weights one, the SSM
    constants as the reference sets them.  The MoE router and the SSMs'
    ``A_log`` and ``D`` stay float32 in every config."""
    return draw_weights(LM(cfg, device=device), generator)


# -- forward passes -----------------------------------------------------------


def lm_forward(cfg: ModelConfig, model: LM, tokens, *, patch_embeds=None,
               q_chunk=512, kv_chunk=1024, logits_mode="all", remat=True,
               q_spec=None, kv_spec=None):
    """tokens: (B, S) int.  VLM: patch_embeds (B, n_img, d) prepended.

    logits_mode: 'all' (training) | 'last' (prefill) | 'none' (returns hidden).
    remat: checkpoint each block while autograd records (a no-op under
    ``torch.no_grad()``).  q_spec/kv_spec: the GQA pinning of a sharded
    step (``launch/steps.py``).  Returns (logits_or_hidden, aux_loss)."""
    _check_model(cfg, model)
    return model(tokens, patch_embeds=patch_embeds, q_chunk=q_chunk,
                 kv_chunk=kv_chunk, logits_mode=logits_mode, remat=remat,
                 q_spec=q_spec, kv_spec=kv_spec)


def lm_loss(cfg: ModelConfig, model: LM, batch: dict, **kw):
    """Mean next-token cross entropy over ``batch`` (``tokens``,
    ``labels``, optional ``loss_mask`` and, for the VLM,
    ``patch_embeds``, whose positions are dropped from the logits, or
    masked out where the logits are split on their rows), plus the MoE
    layers' aux loss.  ``kw`` goes to ``lm_forward``."""
    pe = batch.get("patch_embeds")
    logits, aux = lm_forward(cfg, model, batch["tokens"], patch_embeds=pe,
                             **kw)
    n_img = 0 if pe is None else pe.shape[1]
    labels, mask = batch["labels"], batch.get("loss_mask")
    if n_img and splits_rows(logits):
        # logits on each rank's own rows (``LM._head``): slicing off the
        # image rows would gather them, so the labels and the mask take
        # the logits' rows instead, the image positions in front, masked
        # out (``_in_front``)
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        labels, mask = _in_front(labels, n_img), _in_front(mask, n_img)
    elif n_img:
        logits = logits[:, n_img:]
    return softmax_cross_entropy(logits, labels, mask) + aux


def _in_front(t, n: int):
    """(B, L) DTensor ``t`` with ``n`` zero columns in front: gathered on
    its columns first (``whole_dim``: a few numbers a row, the labels or
    the loss mask), padded on its local rows, its other placements
    kept."""
    t = whole_dim(t, 1)
    local = t.to_local()
    local = torch.cat([local.new_zeros((local.shape[0], n)), local], dim=1)
    shape = (t.shape[0], n + t.shape[1])
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=(shape[1], 1))


# -- serving ------------------------------------------------------------------


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                  device=None):
    """Decode cache, per family: ``{"attn": {"k", "v"}}``, each (L, B,
    max_len, nkv, hd); for the SSM family ``{"ssm": {"conv", "ssm"}}``, the
    layers' states stacked (L, B, ...), ``ssm`` float32 in any ``dtype``;
    for the hybrid both, ``attn`` with one slice per shared-block call
    site."""
    check_family(cfg)
    attn = cfg.n_layers
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        st = ssm_mod.state_init(cfg, batch, dtype, device=device)
        cache["ssm"] = {k: t[None].repeat((cfg.n_layers,) + (1,) * t.ndim)
                        for k, t in st.items()}
        if cfg.family == "ssm":
            return cache
        attn = hybrid_attn_layers(cfg)
    shape = (attn, batch, max_len, cfg.n_kv_heads, cfg.hd())
    cache["attn"] = {k: torch.zeros(shape, dtype=dtype, device=device)
                     for k in ("k", "v")}
    return cache


@torch.no_grad()
def lm_decode_step(cfg: ModelConfig, model: LM, token, cache, pos):
    """token: (B, 1) int; pos: scalar, or (B,) per slot.  Writes the cache
    in place; returns (logits, cache)."""
    _check_model(cfg, model)
    return model.decode_step(token, cache, pos)


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, model: LM, tokens, cache, *,
               patch_embeds=None, q_chunk=512, kv_chunk=1024):
    """Prefill: run the full sequence, write each attention layer's k/v
    into the cache from position 0 and each SSM layer's final states (in
    place, cast to the cache's dtype), return last-token logits."""
    _check_model(cfg, model)
    return model.prefill(tokens, cache, patch_embeds=patch_embeds,
                         q_chunk=q_chunk, kv_chunk=kv_chunk)
