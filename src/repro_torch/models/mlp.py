"""Dense MLPs: SwiGLU (llama/qwen family) and GeLU (whisper).

Port of ``repro/models/mlp.py``.  The module allocates its weights;
``transformer.init_lm`` draws them (``x @ w`` layout, ``(d_in, d_out)``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dtype_of, matmul


class MLP(nn.Module):
    """``wi``, ``wg``, ``wo`` (SwiGLU) or ``wi``, ``bi``, ``wo``, ``bo``
    (GeLU): the reference's ``init_mlp`` and ``mlp``."""

    def __init__(self, cfg, d_ff: int | None = None, *, device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        kw = dict(dtype=dtype_of(cfg.dtype), device=device)
        self.swiglu = cfg.act == "swiglu"
        self.wi = nn.Parameter(torch.empty(d, f, **kw))
        if self.swiglu:
            self.wg = nn.Parameter(torch.empty(d, f, **kw))
        else:
            self.bi = nn.Parameter(torch.zeros(f, **kw))
        self.wo = nn.Parameter(torch.empty(f, d, **kw))
        if not self.swiglu:
            self.bo = nn.Parameter(torch.zeros(d, **kw))

    def forward(self, x):
        if self.swiglu:
            return matmul(F.silu(matmul(x, self.wg)) * matmul(x, self.wi),
                          self.wo)
        h = F.gelu(matmul(x, self.wi) + self.bi, approximate="tanh")
        return matmul(h, self.wo) + self.bo
