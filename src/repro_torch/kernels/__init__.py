from . import minplus  # noqa: F401
