"""Model registry: family dispatch, batch shapes and real batches.

Port of ``repro/models/registry.py``.  ``batch_shapes`` gives the shapes and
torch dtypes of every model input of a shape cell; ``make_batch`` fills them
from a seeded numpy generator, as the reference does, for smoke tests.  ``loss_fn``
picks the family's training loss.  ``input_specs`` gives the same inputs
as meta tensors, the port's ``jax.ShapeDtypeStruct`` stand-ins: shapes
and dtypes, no memory.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.problem import resolve_device
from . import encdec as encdec_mod
from . import transformer as lm_mod
from .common import dtype_of
from .config import ModelConfig, ShapeConfig


def empty_model(cfg: ModelConfig, device):
    """The model of ``cfg`` (an ``EncDec`` for the enc-dec family, else an
    ``LM``) on ``device``, its weights allocated, not drawn."""
    if cfg.family == "encdec":
        return encdec_mod.EncDec(cfg, device=device)
    return lm_mod.LM(cfg, device=device)


def init_model(cfg: ModelConfig, generator: torch.Generator, *,
               device=None):
    """The model of ``cfg`` with weights drawn from ``generator``, on
    ``device`` (CUDA unless the caller asks for the CPU): an ``EncDec``
    for the enc-dec family, else an ``LM``."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return encdec_mod.init_encdec(cfg, generator, device=dev)
    return lm_mod.init_lm(cfg, generator, device=dev)


def loss_fn(cfg: ModelConfig):
    """The family's training loss, ``fn(cfg, model, batch, **kw)``."""
    if cfg.family == "encdec":
        return encdec_mod.encdec_loss
    return lm_mod.lm_loss


# -- shape-cell input construction -------------------------------------------


def _vlm_split(cfg: ModelConfig, seq_len: int) -> tuple[int, int]:
    n_img = min(cfg.n_img_tokens or seq_len // 8, seq_len // 2)
    return n_img, seq_len - n_img


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig, *,
                 masked: bool = False) -> dict[str, Any]:
    """Shapes and dtypes of the input batch for a shape cell.

    ``masked=True`` adds the packed-document ``loss_mask``."""
    B, S = shape.global_batch, shape.seq_len
    emb_dt = dtype_of(cfg.dtype)
    if shape.kind == "train":
        if cfg.family == "encdec":
            # encoder sees S frames; decoder is teacher-forced on S tokens
            out = {
                "frames": ((B, S, cfg.d_model), emb_dt),
                "tokens": ((B, S), torch.int32),
                "labels": ((B, S), torch.int32),
            }
        elif cfg.family == "vlm":
            n_img, n_txt = _vlm_split(cfg, S)
            out = {
                "patch_embeds": ((B, n_img, cfg.d_model), emb_dt),
                "tokens": ((B, n_txt), torch.int32),
                "labels": ((B, n_txt), torch.int32),
            }
        else:
            out = {
                "tokens": ((B, S), torch.int32),
                "labels": ((B, S), torch.int32),
            }
        if masked:
            out["loss_mask"] = (out["labels"][0], torch.float32)
        return out
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": ((B, S, cfg.d_model), emb_dt)}
        if cfg.family == "vlm":
            n_img, n_txt = _vlm_split(cfg, S)
            return {
                "patch_embeds": ((B, n_img, cfg.d_model), emb_dt),
                "tokens": ((B, n_txt), torch.int32),
            }
        return {"tokens": ((B, S), torch.int32)}
    if shape.kind == "decode":
        return {"token": ((B, 1), torch.int32)}
    raise ValueError(shape.kind)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                masked: bool = False) -> dict[str, torch.Tensor]:
    """Every input of a shape cell as a tensor on the meta device."""
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in batch_shapes(cfg, shape, masked=masked).items()}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
               device=None) -> dict:
    """Concrete random batch (smoke tests / examples) on ``device``: the
    reference's numpy draws, in the same order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, d) in batch_shapes(cfg, shape).items():
        if d == torch.int32:
            a = rng.integers(0, cfg.vocab, size=s).astype(np.int32)
        else:
            a = rng.normal(0, 0.02, size=s).astype(np.float32)
        out[k] = torch.from_numpy(a).to(device=dev, dtype=d)
    if "labels" in out and "tokens" in out:
        out["labels"] = torch.roll(out["tokens"], -1, dims=-1)
    return out
