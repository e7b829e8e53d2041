"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 architecture  [arXiv:2410.05355; unverified].

Runs long_500k (attention-free: decode is O(1) in context length).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024, norm="rmsnorm",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256, version=1),
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, vocab=512, dtype="float32",
                     ssm=SSMConfig(d_state=8, d_conv=4, expand=2, dt_rank=8,
                                   version=1))

TRAIN_ACC = 16
