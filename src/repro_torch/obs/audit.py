"""Contract auditor: mechanically check dispatch invariants over a trace.

The port's copy of ``repro/obs/audit.py`` (the same contracts, tolerance,
report and exit codes), so that the port checks its own traces without the
JAX package. On the card a unit's launch is one CUDA-graph replay (or one
eager step) and its pull the one blocking device-to-host read.

The auditor replays a captured trace (the Chrome trace-event JSON a
``Tracer`` exports) and checks them structurally, per contract *unit* — one
decode step, spec window, prefill chunk, or serving tick, as stamped by
``Tracer.new_unit``:

1. **One launch + one pull per miss-free unit.**  A unit with no recorded
   miss, relaunch, or replay must contain exactly one primary ``launch``
   span and exactly one primary queue-draining ``pull`` span.
2. **Rotation strictly at boundaries.**  A ``rotation`` span belonging to a
   unit must not begin before that unit's primary pull begins — rotation
   never races the in-flight window.
3. **Prefetch ship strictly between launch and pull.**  A ``prefetch_ship``
   span must start at-or-after its unit's primary launch starts and finish
   before the primary pull begins — that interval *is* the overlap window,
   so ``overlap_ms`` is derived from these spans rather than trusted from
   the wall-clock side channel in the residency manager.
4. **No KV page used after release.**  ``kv_use`` events (the page set a
   serving window touches) must reference only pages currently granted by
   a ``kv_ensure`` and not yet returned by a ``kv_release``.

``audit(...)`` accepts a Tracer, an exported dict, a list of events, or a
path to a trace file, and returns an :class:`AuditReport`.  Run as a module
(``python -m repro_torch.obs trace.json``) it exits non-zero on violations;
``chip_smoke.py`` audits every engine path's trace with it on the card.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Set, Union

from .tracer import Tracer, span_overlap_ms

# Rounded-microsecond timestamps can reorder genuinely ordered records by at
# most the rounding quantum; tolerate that, nothing more.
_EPS_US = 0.01


class AuditError(AssertionError):
    """Raised by :meth:`AuditReport.raise_for_violations`."""


class AuditReport:
    def __init__(self):
        self.violations: List[str] = []
        self.units_checked = 0
        self.miss_free_units = 0
        self.launches = 0
        self.pulls = 0
        self.rotations = 0
        self.prefetch_spans = 0
        self.kv_events = 0
        self.overlap_ms = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_for_violations(self) -> None:
        if self.violations:
            raise AuditError(
                f"{len(self.violations)} contract violation(s):\n  "
                + "\n  ".join(self.violations[:20])
            )

    def summary(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "violations": len(self.violations),
            "units_checked": self.units_checked,
            "miss_free_units": self.miss_free_units,
            "launches": self.launches,
            "pulls": self.pulls,
            "rotations": self.rotations,
            "prefetch_spans": self.prefetch_spans,
            "kv_events": self.kv_events,
            "overlap_ms_from_spans": round(self.overlap_ms, 3),
        }


TraceLike = Union[Tracer, Dict[str, Any], List[Dict[str, Any]], str]


def _events(trace: TraceLike) -> List[Dict[str, Any]]:
    if isinstance(trace, Tracer):
        trace = trace.chrome_trace()
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [ev for ev in trace if ev.get("ph") != "M"]


def _kind(ev: Dict[str, Any]) -> Optional[str]:
    return (ev.get("args") or {}).get("kind")

def _unit(ev: Dict[str, Any]) -> int:
    return int((ev.get("args") or {}).get("unit", 0) or 0)

def _end(ev: Dict[str, Any]) -> float:
    return float(ev["ts"]) + float(ev.get("dur", 0.0))


def audit(trace: TraceLike) -> AuditReport:
    events = _events(trace)
    rep = AuditReport()
    rep.overlap_ms = span_overlap_ms(events)

    units: Dict[int, Dict[str, List[Dict[str, Any]]]] = {}
    for ev in events:
        u = _unit(ev)
        name = ev.get("name")
        if name == "launch":
            rep.launches += 1
        elif name == "pull":
            rep.pulls += 1
        elif name == "rotation":
            rep.rotations += 1
        elif name == "prefetch_ship":
            rep.prefetch_spans += 1
        if u <= 0:
            continue
        bucket = units.setdefault(u, {})
        bucket.setdefault(name, []).append(ev)

    for u in sorted(units):
        bucket = units[u]
        rep.units_checked += 1
        launches = bucket.get("launch", [])
        pulls = bucket.get("pull", [])
        primary_launches = [e for e in launches if _kind(e) in (None, "primary")]
        primary_pulls = [e for e in pulls if _kind(e) in (None, "primary")]

        exempt = bool(
            bucket.get("miss")
            or bucket.get("replay")
            or any(_kind(e) == "relaunch" for e in launches + pulls)
        )
        # Contract 1: exact dispatch economy on the miss-free fast path.
        if not exempt and (launches or pulls):
            rep.miss_free_units += 1
            if len(primary_launches) != 1:
                rep.violations.append(
                    f"unit {u}: {len(primary_launches)} primary launches "
                    f"in a miss-free unit (want exactly 1)"
                )
            if len(primary_pulls) != 1:
                rep.violations.append(
                    f"unit {u}: {len(primary_pulls)} primary pulls in a "
                    f"miss-free unit (want exactly 1)"
                )

        pull0 = min(primary_pulls, key=lambda e: e["ts"]) if primary_pulls \
            else None
        launch0 = min(primary_launches, key=lambda e: e["ts"]) \
            if primary_launches else None

        # Contract 2: rotation only after the unit's pull has begun.
        if pull0 is not None:
            for rot in bucket.get("rotation", []):
                if float(rot["ts"]) + _EPS_US < float(pull0["ts"]):
                    rep.violations.append(
                        f"unit {u}: rotation at ts={rot['ts']} begins "
                        f"mid-window, before the primary pull at "
                        f"ts={pull0['ts']}"
                    )

        # Contract 3: prefetch ship inside the launch→pull overlap window.
        for ship in bucket.get("prefetch_ship", []):
            if launch0 is not None and \
                    float(ship["ts"]) + _EPS_US < float(launch0["ts"]):
                rep.violations.append(
                    f"unit {u}: prefetch_ship at ts={ship['ts']} dispatched "
                    f"before the launch at ts={launch0['ts']}"
                )
            if pull0 is not None and \
                    _end(ship) > float(pull0["ts"]) + _EPS_US:
                rep.violations.append(
                    f"unit {u}: prefetch_ship ending at ts={_end(ship)} "
                    f"overruns the pull at ts={pull0['ts']}"
                )

    _audit_kv(events, rep)
    return rep


def _audit_kv(events: List[Dict[str, Any]], rep: AuditReport) -> None:
    """Contract 4: page-lifetime discipline, replayed in event order."""
    live: Set[int] = set()
    owner: Dict[int, int] = {}
    kv = [ev for ev in events
          if ev.get("name") in ("kv_reserve", "kv_ensure", "kv_release",
                                "kv_use")]
    kv.sort(key=lambda e: float(e["ts"]))
    rep.kv_events = len(kv)
    for ev in kv:
        args = ev.get("args") or {}
        name = ev["name"]
        if name == "kv_ensure":
            for p in args.get("pages", []):
                live.add(int(p))
                owner[int(p)] = int(args.get("uid", -1))
        elif name == "kv_release":
            for p in args.get("pages", []):
                p = int(p)
                if p not in live:
                    rep.violations.append(
                        f"kv: uid {args.get('uid')} released page {p} "
                        f"which was not live (double release?)"
                    )
                live.discard(p)
        elif name == "kv_use":
            for p in args.get("pages", []):
                if int(p) not in live:
                    rep.violations.append(
                        f"kv: page {p} used at ts={ev['ts']} after release "
                        f"(or never granted)"
                    )


def main(argv: Optional[Iterable[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Audit a Chrome trace-event JSON for dispatch-contract "
                    "violations.")
    ap.add_argument("trace", help="path to a trace file written by "
                                  "Tracer.write / serve.py --trace-out")
    args = ap.parse_args(list(argv) if argv is not None else None)
    rep = audit(args.trace)
    print("audit:", json.dumps(rep.summary()))
    if not rep.ok:
        for v in rep.violations:
            print("VIOLATION:", v)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
