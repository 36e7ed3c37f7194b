"""Observability: span tracer and metrics registry (the contract auditor of
the reference is not ported yet)."""
from .metrics import (BYTES_BUCKETS, LATENCY_MS_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry)
from .tracer import MACHINE_TRACKS, Tracer, resolve_tracer, span_overlap_ms

__all__ = [
    "BYTES_BUCKETS", "LATENCY_MS_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry",
    "MACHINE_TRACKS", "Tracer", "resolve_tracer", "span_overlap_ms",
]
