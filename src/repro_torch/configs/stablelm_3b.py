"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304  [hf:stabilityai/stablelm-2-1_6b; unverified].

StableLM uses LayerNorm and partial-rotary attention; we model LN + full
rotary (partial-rotary is a fidelity note, not a structural difference).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
    act="swiglu", norm="layernorm", rope_theta=10000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=176, vocab=512, dtype="float32")

TRAIN_ACC = 4  # gradient-accumulation microbatches for train_4k
TRAIN_MODE = "seq"
