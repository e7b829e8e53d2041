from .engine import Engine, Request, cache_insert, mask_top_k, sample_logits  # noqa: F401
