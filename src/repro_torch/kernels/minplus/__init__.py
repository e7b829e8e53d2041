from . import batched  # noqa: F401
from .batched import (  # noqa: F401
    batched_superstep,
    batched_superstep_plain,
    plain_superstep,
)
