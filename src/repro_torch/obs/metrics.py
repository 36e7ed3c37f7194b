"""Counters, gauges, and bucketed histograms with Prometheus exposition.

The registry backs the serving latency summary (TTFT/ITL percentiles that
used to be hand-rolled ``np.percentile`` calls over request timestamps) and
collects per-event distributions the aggregate ``EngineStats`` bag cannot
express: window wall time and per-dispatch upload bytes.  ``serve.py
--metrics-port`` serves :meth:`MetricsRegistry.exposition` over HTTP;
:meth:`MetricsRegistry.summary` is the one-shot dict the benchmark scripts
merge into ``BENCH_decode.json`` / ``BENCH_serving.json`` rows.

Histograms keep both Prometheus-style cumulative bucket counts (for
exposition) and the raw samples (bounded) so percentiles stay exact —
swapping the serving summary onto the registry must not change the numbers
the gates compare.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence

# Default bucket boundaries (upper bounds) per histogram family.
LATENCY_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 10000.0)
BYTES_BUCKETS = (4096.0, 65536.0, 1048576.0, 4194304.0, 16777216.0,
                 67108864.0, 268435456.0)

_MAX_RAW_SAMPLES = 200_000


class Counter:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Cumulative-bucket histogram that also retains raw samples.

    ``percentile`` reads the raw samples (exact, matching the legacy
    ``np.percentile`` behaviour with linear interpolation); the bucket
    counts exist for Prometheus exposition.  Raw retention is capped at
    ``_MAX_RAW_SAMPLES`` — past that, percentiles fall back to bucket
    interpolation (serving runs in this repo never get close).
    """

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_MS_BUCKETS):
        self.name = name
        self.help = help
        self.bounds: List[float] = sorted(float(b) for b in buckets)
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)  # +Inf
        self.count = 0
        self.sum = 0.0
        self._raw: List[float] = []

    def reset(self) -> None:
        """Drop all samples (callers that rebuild a distribution from a
        source of truth — e.g. the serving latency summary re-deriving
        TTFT/ITL from completed requests — reset before re-observing)."""
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self._raw = []

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        if len(self._raw) < _MAX_RAW_SAMPLES:
            self._raw.append(v)

    def percentile(self, q: float) -> float:
        """q in [0, 100], linear interpolation over raw samples."""
        if self.count == 0:
            return 0.0
        if len(self._raw) == self.count:
            xs = sorted(self._raw)
            pos = (q / 100.0) * (len(xs) - 1)
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
        return self._bucket_percentile(q)

    def _bucket_percentile(self, q: float) -> float:
        target = (q / 100.0) * self.count
        seen = 0
        lo = 0.0
        for i, c in enumerate(self.bucket_counts):
            hi = self.bounds[i] if i < len(self.bounds) else lo
            if seen + c >= target:
                if c == 0:
                    return hi
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
            lo = hi
        return lo

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Named metric store with Prometheus text exposition."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- accessors
    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_MS_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, help, buckets)
        return h

    # ------------------------------------------------------------ ingestion
    def set_from(self, counters: Dict[str, float]) -> None:
        """Mirror an aggregate stats dict into gauges (live exposition)."""
        for k, v in counters.items():
            if isinstance(v, (int, float)):
                self.gauge(f"engine_{k}").set(v)

    # -------------------------------------------------------------- output
    def exposition(self) -> str:
        """Prometheus text format (version 0.0.4)."""
        lines: List[str] = []
        for c in sorted(self._counters.values(), key=lambda m: m.name):
            if c.help:
                lines.append(f"# HELP {c.name} {c.help}")
            lines.append(f"# TYPE {c.name} counter")
            lines.append(f"{c.name} {_fmt(c.value)}")
        for g in sorted(self._gauges.values(), key=lambda m: m.name):
            if g.help:
                lines.append(f"# HELP {g.name} {g.help}")
            lines.append(f"# TYPE {g.name} gauge")
            lines.append(f"{g.name} {_fmt(g.value)}")
        for h in sorted(self._histograms.values(), key=lambda m: m.name):
            if h.help:
                lines.append(f"# HELP {h.name} {h.help}")
            lines.append(f"# TYPE {h.name} histogram")
            cum = 0
            for bound, cnt in zip(h.bounds, h.bucket_counts):
                cum += cnt
                lines.append(f'{h.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
            lines.append(f'{h.name}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{h.name}_sum {_fmt(h.sum)}")
            lines.append(f"{h.name}_count {h.count}")
        return "\n".join(lines) + "\n"

    def summary(self) -> Dict[str, object]:
        """One-shot dump merged into benchmark JSON rows."""
        out: Dict[str, object] = {}
        for c in self._counters.values():
            out[c.name] = c.value
        for g in self._gauges.values():
            out[g.name] = g.value
        for h in self._histograms.values():
            out[h.name] = {
                "count": h.count,
                "sum": round(h.sum, 6),
                "mean": round(h.mean, 6),
                "p50": round(h.percentile(50), 6),
                "p95": round(h.percentile(95), 6),
                "p99": round(h.percentile(99), 6),
            }
        return out


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def serve_metrics(registry_fn, port: int):
    """Start a daemon HTTP thread serving ``/metrics`` from ``registry_fn()``.

    ``registry_fn`` is called per scrape so gauges mirror live engine state.
    Returns the ``http.server`` instance (call ``shutdown()`` to stop).
    Binds to 127.0.0.1 only — this is a local debugging surface.
    """
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = registry_fn().exposition().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-request stderr noise
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
