from . import minplus, place  # noqa: F401
