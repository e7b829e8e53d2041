"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias  [arXiv:2407.10671; hf].

Tied embeddings (qwen2-0.5b shares input/output embedding); 14 heads / 2 KV
heads shard unevenly on the 16-way model axis.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936,
    act="swiglu", norm="rmsnorm", qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                     d_ff=160, vocab=512, dtype="float32")

TRAIN_ACC = 1

# §Perf hillclimb B: 14 q / 2 kv heads don't divide the 16-way model axis;
# tensor parallelism degenerates into per-chunk all-reduces (the baseline
# cell is 172x collective-bound).  Sequence parallelism makes every
# sub-layer token-local.
TRAIN_MODE = "seq"
