"""Telemetry for the port: the request-lifecycle tracer (``trace``).
The metrics registry and the Perfetto export are not ported yet."""
from .trace import NULL, NullTracer, Tracer

__all__ = ["NULL", "NullTracer", "Tracer"]
