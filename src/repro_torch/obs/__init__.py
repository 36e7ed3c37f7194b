"""Observability: span tracer, metrics registry, and the contract auditor
(the port's copies of ``repro/obs``; the auditor checks the same four
contracts over the port's traces)."""
from .audit import AuditError, AuditReport, audit
from .metrics import (BYTES_BUCKETS, LATENCY_MS_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, serve_metrics)
from .tracer import MACHINE_TRACKS, Tracer, resolve_tracer, span_overlap_ms

__all__ = [
    "AuditError", "AuditReport", "audit",
    "BYTES_BUCKETS", "LATENCY_MS_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "serve_metrics",
    "MACHINE_TRACKS", "Tracer", "resolve_tracer", "span_overlap_ms",
]
