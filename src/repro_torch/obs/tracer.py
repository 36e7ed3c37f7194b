"""Host-side span/event tracer with Chrome trace-event export.

The tracer is a ring buffer of ``(phase, name, track, lane, t0, dur, unit,
args)`` tuples recorded with :func:`time.perf_counter`.  Every asynchronous
machine in the engine gets its own *track* (launch / pull / rotation /
prefetch / kv_pool / request) and, in serving, every request gets its own
*lane* so the Perfetto timeline shows one row per in-flight request.

Tracing is opt-in.  The engines normalise ``trace=None`` (and any tracer with
``enabled=False``) to *no tracer at all* — every emission site is guarded by
a plain ``if tr is not None`` so the tracing-off hot path executes exactly
the same instructions as before this subsystem existed.  That is the
"disabled overhead is unmeasurable" contract the decode benchmark asserts
structurally (see ``benchmarks/decode_hot_path.py``).

Span records carry the tracer's *current unit* — a monotonically increasing
id the engine bumps once per decode step / spec window / prefill chunk /
serving tick via :meth:`Tracer.new_unit`.  The contract auditor
(``repro.obs.audit`` in the JAX reference) groups events by unit to check the standing dispatch
invariants (one launch + one queue-draining pull per miss-free unit,
rotation strictly after the pull, prefetch ship strictly between launch and
pull).
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

# Track names in display order.  Chrome trace tids are assigned from this
# list first so the Perfetto timeline always shows the machines in pipeline
# order; unknown tracks are appended on demand.
MACHINE_TRACKS = ("launch", "pull", "rotation", "prefetch", "kv_pool")

_PID_MACHINES = 1
_PID_REQUESTS = 2


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tr", "name", "track", "args", "t0", "duration_s")

    def __init__(self, tr: "Tracer", name: str, track: str, args):
        self._tr = tr
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0.0
        self.duration_s = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        self.duration_s = t1 - self.t0
        tr = self._tr
        tr._buf.append(
            ("X", self.name, self.track, None, self.t0, self.duration_s,
             tr.unit, self.args)
        )


class Tracer:
    """Ring-buffered span/event recorder.

    Parameters
    ----------
    capacity:
        Maximum number of retained records; older records are dropped
        (ring-buffer semantics) so long runs stay bounded.
    enabled:
        A tracer constructed with ``enabled=False`` is normalised away by
        the engines (they keep no tracer reference at all), making the
        disabled path bit-identical to the untraced one.
    """

    def __init__(self, capacity: int = 200_000, *, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._epoch = time.perf_counter()
        # Current contract unit (decode step / window / chunk / tick).  0
        # means "outside any unit" (warm start, prefill walk, teardown);
        # the auditor ignores those records for per-unit invariants.
        self.unit = 0
        self._next_unit = 0
        self.unit_kind: Optional[str] = None

    # ------------------------------------------------------------- recording
    def span(self, name: str, track: str = "launch",
             args: Optional[Dict[str, Any]] = None) -> _Span:
        """Record a complete event covering the ``with`` body."""
        return _Span(self, name, track, args)

    def complete(self, name: str, track: str, t0: float, t1: float,
                 lane: Optional[int] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete event with explicit perf_counter endpoints.

        Used for request-lane phases (queued/prefill/decode) whose
        boundaries are already stamped on the ``Request`` object.
        """
        self._buf.append(("X", name, track, lane, t0, max(0.0, t1 - t0),
                          self.unit, args))

    def instant(self, name: str, track: str = "launch",
                lane: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        self._buf.append(("i", name, track, lane, time.perf_counter(), 0.0,
                          self.unit, args))

    def new_unit(self, kind: str) -> int:
        """Open the next contract unit (step / window / chunk / tick)."""
        self._next_unit += 1
        self.unit = self._next_unit
        self.unit_kind = kind
        self.instant("unit", "launch", args={"kind": kind})
        return self.unit

    # ------------------------------------------------------------ inspection
    def __len__(self) -> int:
        return len(self._buf)

    def records(self) -> List[tuple]:
        return list(self._buf)

    def overlap_ms(self) -> float:
        """Span-derived prefetch overlap: total prefetch-ship duration.

        This is the trace-native replacement for the wall-clock side
        channel the residency manager keeps in ``EngineStats.overlap_ms``;
        a regression test checks the two agree on a miss-starved run.
        """
        return sum(r[5] for r in self._buf
                   if r[0] == "X" and r[1] == "prefetch_ship") * 1e3

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> Dict[str, Any]:
        """Render the buffer as a Chrome trace-event JSON object.

        Machines map to ``pid=1`` with one tid per track; request lanes map
        to ``pid=2`` with tid = request uid.  Metadata events name both so
        Perfetto shows readable track labels.
        """
        tids: Dict[str, int] = {t: i for i, t in enumerate(MACHINE_TRACKS)}
        events: List[Dict[str, Any]] = []
        lanes = set()
        for ph, name, track, lane, t0, dur, unit, args in self._buf:
            ts_us = (t0 - self._epoch) * 1e6
            if lane is not None:
                pid, tid = _PID_REQUESTS, int(lane)
                lanes.add(tid)
            else:
                if track not in tids:
                    tids[track] = len(tids)
                pid, tid = _PID_MACHINES, tids[track]
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "pid": pid, "tid": tid,
                "ts": round(ts_us, 3), "cat": track,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"
            a = dict(args) if args else {}
            a["unit"] = unit
            ev["args"] = a
            events.append(ev)
        meta: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": _PID_MACHINES,
             "args": {"name": "machines"}},
            {"ph": "M", "name": "process_name", "pid": _PID_REQUESTS,
             "args": {"name": "requests"}},
        ]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": _PID_MACHINES, "tid": tid,
                         "args": {"name": track}})
        for lane in sorted(lanes):
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": _PID_REQUESTS, "tid": lane,
                         "args": {"name": f"request {lane}"}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def resolve_tracer(trace: Optional[Tracer]) -> Optional[Tracer]:
    """Normalise an engine ``trace=`` argument.

    Returns ``None`` for ``None`` *and* for disabled tracers, so the
    engines' emission guards (``if tr is not None``) make the disabled
    path identical to the untraced one — provably zero overhead.
    """
    if trace is None or not trace.enabled:
        return None
    return trace


def span_overlap_ms(events: Iterable[Dict[str, Any]]) -> float:
    """Sum prefetch-ship span durations (ms) from exported Chrome events."""
    total_us = 0.0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "prefetch_ship":
            total_us += float(ev.get("dur", 0.0))
    return total_us / 1e3
