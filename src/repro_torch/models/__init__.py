"""Model side of the port (mirrors ``repro.models``): configs, the dense,
VLM, MoE, SSM and hybrid decoder-only LMs, the enc-dec backbone, the
registry, and carrying weights across from the JAX package (``carry``)."""
from .config import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES  # noqa: F401
from .registry import init_model, make_batch  # noqa: F401
