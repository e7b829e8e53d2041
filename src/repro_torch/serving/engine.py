"""Slot-based continuous-batching serving engine.

Port of ``repro/serving/engine.py``.  A fixed pool of ``n_slots`` sequences
decodes in lock-step (one per-slot-position decode step per tick); finished
slots are refilled from the request queue by prefilling the new prompt at
batch 1 and scattering its KV cache into the slot (``cache_insert``).
Sampling: temperature / top-k, from a ``torch.Generator`` seeded by
``seed``.  The port runs eagerly: the reference's ``jax.jit`` has no
counterpart.

Under an MoE model a slot's tokens depend on the other slots, as in the
reference: a decode tick routes all ``n_slots`` tokens (idle slots
included) through one set of expert capacity buffers, whose size counts
them all, so a pair of one slot can be dropped because of the others'
routing.  The same prompt can therefore decode differently in another
batch, or through ``lm_forward`` over the whole sequence.

The engine serves the decoder-only families: dense, VLM, MoE, SSM and
hybrid (enc-dec raises, as the reference's assertion does).  It keeps its
cache in float32, as the reference's does (``serving/engine.py:63``).  A
bfloat16 model's decode attention then promotes the residual to float32
and the reference's layer scan rejects the carry
(``models/transformer.py:324``, ``:383`` for the hybrid's shared block), so
for every family with attention the port raises for a bfloat16 config
rather than serve what the reference cannot.  The SSM family has no
attention: its decode keeps the residual in the model's dtype over the
float32 states, and both engines serve it in bfloat16.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.problem import resolve_device
from ..models import transformer as lm
from ..models.config import ModelConfig

NEG = -1e30  # the reference's top-k fill


def mask_top_k(logits, top_k: int):
    """Logits below the k-th largest of their row set to -1e30; ties at the
    k-th value stay."""
    v = torch.topk(logits, top_k, dim=-1).values
    return torch.where(logits < v[:, -1:], NEG, logits)


def sample_logits(generator: torch.Generator, logits, *,
                  temperature: float = 1.0, top_k: int = 0):
    """logits (B, V) -> token ids (B,) int32.  ``temperature <= 0`` is
    argmax (the first index on ties); otherwise a categorical draw by the
    Gumbel-max rule, as ``jax.random.categorical`` draws (the streams of
    the two packages differ)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k:
        logits = mask_top_k(logits, top_k)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def cache_insert(cache_pool, cache_one, slot: int):
    """Copy a batch-1 cache into slot ``slot`` of the pool, in place.

    Attention caches have layout (L, B, S, ...); SSM states (L, B, ...)."""
    for key, pool in cache_pool.items():
        one = cache_one[key]
        if isinstance(pool, dict):
            cache_insert(pool, one, slot)
        else:
            pool[:, slot] = one[:, 0].to(pool.dtype)
    return cache_pool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (T,) int32
    max_new: int = 32
    out: Optional[list] = None


class Engine:
    def __init__(self, cfg: ModelConfig, model: lm.LM, *, n_slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, device=None):
        """``model`` lies on ``device`` (CUDA unless the caller passes
        ``device="cpu"``)."""
        self.device = resolve_device(device)
        lm.check_family(cfg)
        if cfg.dtype != "float32" and cfg.family != "ssm":
            raise ValueError(
                f"{cfg.name}: the engine serves {cfg.family} configs in "
                f"float32 only, not {cfg.dtype}.  The reference engine "
                "keeps its KV cache in float32 (serving/engine.py:63), so a "
                "bfloat16 model's decode attention promotes the residual to "
                "float32 and the reference's layer scan rejects the carry "
                "(models/transformer.py:324); serve cfg.with_(dtype="
                "'float32')")
        self.cfg, self.model = cfg, model
        self.n_slots, self.max_len = n_slots, max_len
        self.temperature, self.top_k = temperature, top_k
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = lm.init_lm_cache(cfg, n_slots, max_len, torch.float32,
                                      device=self.device)
        self.pos = np.zeros(n_slots, np.int32)  # next write position
        self.active: list[Optional[Request]] = [None] * n_slots
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.queue: list[Request] = []
        self.done: list[Request] = []

        self._decode = lambda m, t, c, pos: lm.lm_decode_step(cfg, m, t, c, pos)
        self._prefill = lambda m, t, c: lm.lm_prefill(cfg, m, t, c)

    def _sample(self, logits):
        return sample_logits(self.generator, logits,
                             temperature=self.temperature, top_k=self.top_k)

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _fill_slot(self, slot: int):
        if not self.queue:
            return
        req = self.queue.pop(0)
        c1 = lm.init_lm_cache(self.cfg, 1, self.max_len, torch.float32,
                              device=self.device)
        prompt = torch.from_numpy(req.prompt[None, :].astype(np.int32))
        logits, c1 = self._prefill(self.model, prompt.to(self.device), c1)
        self.cache = cache_insert(self.cache, c1, slot)
        tok = int(self._sample(logits[:, -1])[0])
        req.out.append(tok)
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_tok[slot, 0] = tok

    def step(self):
        """One engine tick: refill free slots, one decode step for all."""
        for s in range(self.n_slots):
            if self.active[s] is None:
                self._fill_slot(s)
        if not any(self.active):
            return False
        logits, self.cache = self._decode(
            self.model, torch.from_numpy(self.last_tok).to(self.device),
            self.cache, torch.from_numpy(self.pos).to(self.device))
        toks = self._sample(logits[:, 0]).cpu().numpy()
        for s in range(self.n_slots):
            req = self.active[s]
            if req is None:
                continue
            self.pos[s] += 1
            req.out.append(int(toks[s]))
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                self.done.append(req)
                self.active[s] = None
            else:
                self.last_tok[s, 0] = int(toks[s])
        return True

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.active)) and ticks < max_ticks:
            if not self.step():
                break
            ticks += 1
        return self.done, ticks
