"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (STUB)  [arXiv:2212.04356; unverified].

Frontend stub per the assignment: input_specs() provides precomputed frame
embeddings (B, S, d); the 2x stride-2 conv stem is not executed.  Shapes:
train_4k = enc 4096 frames + teacher-forced dec 4096 tokens; prefill_32k =
encoder over 32768 frames filling cross K/V; decode_32k = one decoder token
against self-cache 32768 + cross-cache 32768 (DESIGN.md §6).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    act="gelu", norm="layernorm", n_enc_layers=24, n_dec_layers=24,
    max_target_len=448, tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=2, n_enc_layers=2, n_dec_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                     max_target_len=64, dtype="float32")

TRAIN_ACC = 8
