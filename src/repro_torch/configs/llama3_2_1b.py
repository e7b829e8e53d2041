"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3  [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=128256,
    act="swiglu", norm="rmsnorm", tie_embeddings=True, rope_theta=500_000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=192, vocab=512, dtype="float32")

TRAIN_ACC = 2
TRAIN_MODE = "seq"
