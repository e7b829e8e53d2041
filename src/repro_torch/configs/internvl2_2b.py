"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2  [arXiv:2404.16821; hf].

Backbone only per the assignment: the InternViT frontend is a STUB —
input_specs() provides precomputed patch embeddings prepended to the text
tokens (train_4k: 1024 patches + 3072 text; prefill_32k: 4096 + 28672).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92553,
    act="swiglu", norm="rmsnorm", rope_theta=1_000_000.0, n_img_tokens=1024,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=192, vocab=512, n_img_tokens=8, dtype="float32")

TRAIN_ACC = 2
TRAIN_MODE = "seq"
