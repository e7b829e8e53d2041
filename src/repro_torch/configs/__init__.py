"""Assigned-architecture registry: ``get_config("qwen2.5-14b")`` etc.

Port of ``repro/configs``: the same ten configurations (each module's
docstring names the model's public source), over the port's own
``repro_torch.models.config``."""
from __future__ import annotations

import importlib

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2-0.5b": "qwen2_0_5b",
    "llama3.2-1b": "llama3_2_1b",
    "whisper-medium": "whisper_medium",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-7b": "zamba2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-2b": "internvl2_2b",
}

ARCHS = list(_MODULES)

# long_500k applicability (DESIGN.md §6): sub-quadratic families only.
LONG_CONTEXT_OK = {"zamba2-7b", "falcon-mamba-7b"}


def _mod(name: str):
    key = name.replace("_", "-").lower()
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")


def get_config(name: str, smoke: bool = False):
    m = _mod(name)
    return m.SMOKE if smoke else m.CONFIG


def train_accumulation(name: str) -> int:
    return getattr(_mod(name), "TRAIN_ACC", 1)


def train_mode(name: str) -> str:
    """'tp' (tensor parallel, default) or 'seq' (sequence parallelism — used
    where head counts don't divide the model axis; EXPERIMENTS.md §Perf B)."""
    return getattr(_mod(name), "TRAIN_MODE", "tp")


def cells(include_skipped: bool = False):
    """All (arch, shape_name) dry-run cells; skipped long_500k cells are
    excluded unless requested."""
    from repro_torch.models.config import SHAPES

    out = []
    for a in ARCHS:
        for s in SHAPES:
            skipped = s == "long_500k" and a not in LONG_CONTEXT_OK
            if skipped and not include_skipped:
                continue
            out.append((a, s))
    return out
