from . import batched, minplus, ops  # noqa: F401
from .batched import (  # noqa: F401
    batched_superstep,
    batched_superstep_plain,
    plain_superstep,
)
from .minplus import masked_minplus_cuda, masked_minplus_plain  # noqa: F401
from .ops import masked_minplus, masked_minplus_ref  # noqa: F401
