"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained; first layer is
dense (d_ff 10944)  [arXiv:2401.06066; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    act="swiglu", norm="rmsnorm",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, d_ff_shared=2816,
                  first_dense_layers=1, d_ff_dense=10944,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=64, vocab=512, dtype="float32",
                     moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                   n_shared_experts=1, d_ff_shared=128,
                                   first_dense_layers=1, d_ff_dense=192,
                                   capacity_factor=1.25))

TRAIN_ACC = 8
