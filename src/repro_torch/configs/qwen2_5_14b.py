"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias  [hf:Qwen/Qwen2.5-0.5B; hf].

40 q-heads on a 16-way model axis shard unevenly (GSPMD pads to 48);
see DESIGN.md §4 and the roofline notes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
    act="swiglu", norm="rmsnorm", qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
                     d_ff=224, vocab=512, dtype="float32")

TRAIN_ACC = 16
