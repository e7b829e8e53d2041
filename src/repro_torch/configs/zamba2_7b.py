"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + ONE shared transformer block
applied every 6 mamba blocks (weights reused, per-call-site KV cache)
[arXiv:2411.15242; unverified].

Runs long_500k: mamba decode state is O(1); the 14 shared-attention call
sites decode against a (cache_seq-sharded) 512k KV cache.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    act="swiglu", norm="rmsnorm", attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_p=64, version=2),
)

SMOKE = CONFIG.with_(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=160, vocab=512, attn_every=2, dtype="float32",
                     ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_p=32,
                                   version=2))

TRAIN_ACC = 16
