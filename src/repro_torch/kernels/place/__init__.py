from . import ops, place  # noqa: F401
from .ops import place_window, place_window_ref  # noqa: F401
from .place import place_window_cuda, place_window_plain  # noqa: F401
