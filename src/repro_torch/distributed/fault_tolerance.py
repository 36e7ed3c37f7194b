"""Fault tolerance: heartbeat failure detection + deterministic restart policy
(a copy of the reference's ``distributed/fault_tolerance.py``, which is plain
Python; the port keeps its own so that it imports nothing of the JAX package).

On real fleets this wraps the coordination service; here the same state machine
runs against a simulated clock so the restart logic (including elastic
downsize) is unit-testable. The contract with the trainer:

  * every worker heartbeats each step; a worker silent for ``timeout_s`` is
    declared failed;
  * on failure the job transitions RUNNING -> RESTARTING, reloads the latest
    committed checkpoint (manager skips uncommitted partials), and resumes on
    the surviving mesh (elastic resharding) once ``min_workers`` are healthy;
  * repeated failures back off exponentially up to ``max_restarts``.

Straggler mitigation for training: a worker whose step time exceeds
``straggler_factor`` x median for ``straggler_patience`` consecutive steps is
treated as failed (preemptive restart beats a 10x-slow fleet).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class JobState(enum.Enum):
    RUNNING = "running"
    RESTARTING = "restarting"
    FAILED = "failed"


@dataclass
class WorkerHealth:
    last_heartbeat: float = 0.0
    step_times: List[float] = field(default_factory=list)
    slow_streak: int = 0
    alive: bool = True


class FaultTolerantCoordinator:
    def __init__(
        self,
        num_workers: int,
        *,
        timeout_s: float = 60.0,
        min_workers: Optional[int] = None,
        max_restarts: int = 5,
        straggler_factor: float = 3.0,
        straggler_patience: int = 3,
    ):
        self.num_workers = num_workers
        self.timeout_s = timeout_s
        self.min_workers = min_workers or num_workers
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.workers: Dict[int, WorkerHealth] = {
            i: WorkerHealth() for i in range(num_workers)
        }
        self.state = JobState.RUNNING
        self.restarts = 0
        self.restart_log: List[Dict] = []

    # ------------------------------------------------------------------
    def heartbeat(self, worker: int, now: float, step_time: Optional[float] = None) -> None:
        w = self.workers[worker]
        w.last_heartbeat = now
        if step_time is not None:
            w.step_times.append(step_time)
            if len(w.step_times) > 32:
                w.step_times.pop(0)

    def _median_step(self) -> float:
        all_t = sorted(
            t for w in self.workers.values() if w.alive for t in w.step_times[-8:]
        )
        return all_t[len(all_t) // 2] if all_t else 0.0

    def check(self, now: float) -> JobState:
        """Advance the state machine; call once per coordinator tick."""
        med = self._median_step()
        failed = []
        for i, w in self.workers.items():
            if not w.alive:
                continue
            if now - w.last_heartbeat > self.timeout_s:
                failed.append((i, "heartbeat timeout"))
                continue
            if med > 0 and w.step_times:
                if w.step_times[-1] > self.straggler_factor * med:
                    w.slow_streak += 1
                    if w.slow_streak >= self.straggler_patience:
                        failed.append((i, f"straggler ({w.step_times[-1]:.2f}s vs median {med:.2f}s)"))
                else:
                    w.slow_streak = 0
        for i, reason in failed:
            self.workers[i].alive = False
            self.restart_log.append({"worker": i, "reason": reason, "at": now})
        if failed:
            self.restarts += 1
            if self.restarts > self.max_restarts:
                self.state = JobState.FAILED
            else:
                self.state = JobState.RESTARTING
        return self.state

    def alive_workers(self) -> List[int]:
        return [i for i, w in self.workers.items() if w.alive]

    def try_resume(self, now: float) -> bool:
        """RESTARTING -> RUNNING when enough healthy workers remain (elastic:
        the surviving set becomes the new mesh)."""
        if self.state is not JobState.RESTARTING:
            return self.state is JobState.RUNNING
        if len(self.alive_workers()) >= self.min_workers:
            self.state = JobState.RUNNING
            for i in self.alive_workers():
                self.workers[i].last_heartbeat = now
            return True
        return False

    def backoff_s(self) -> float:
        return min(60.0 * 2 ** max(self.restarts - 1, 0), 900.0)
