"""Telemetry plane of the port: metrics registry, request-lifecycle tracer,
Chrome-trace/Perfetto export (mirrors ``repro.obs``)."""
from .metrics import (
    Histogram, MetricsRegistry, absorb_engine_stats, absorb_gossip_stats,
    absorb_online_stats, absorb_span_stats, absorb_timing,
)
from .trace import NULL, NullTracer, Tracer
from .export import (
    reconstruct_request, text_timeline, to_chrome_trace,
    validate_chrome_trace, write_chrome_trace,
)

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "NULL",
    "NullTracer",
    "Tracer",
    "absorb_engine_stats",
    "absorb_gossip_stats",
    "absorb_online_stats",
    "absorb_span_stats",
    "absorb_timing",
    "reconstruct_request",
    "text_timeline",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
]
