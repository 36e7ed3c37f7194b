"""Cyclic rotation of the slot group (the patent's rotary transform).

Experts are arranged on a *ring* ordered by long-horizon demand (EMA). The
resident set is a contiguous window of ``num_slots`` ring positions. Residency
advances by bounded forward/reverse rotation of the window — in contrast to LRU,
whose eviction order is a one-way recency stream with no structured way back.

Cyclical return: the rotation state keeps snapshots of (demand vector, window
position); when current demand correlates with a stored snapshot above a
threshold, the window rotates back to that snapshot's position — the paper's
"recurring semantic context allows cyclical return to a prior slot set".
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

import numpy as np


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b) / (na * nb)


@dataclass
class RotationDecision:
    delta: int                     # signed ring rotation applied this step
    reverse_jump: bool             # True if a cyclical-return jump was taken
    window: np.ndarray             # expert ids now in the window


class RotaryRing:
    """Ring ordering + rotating window over experts of ONE layer."""

    def __init__(
        self,
        num_experts: int,
        num_slots: int,
        *,
        max_stride: int = 4,
        reverse_threshold: float = 0.85,
        snapshot_every: int = 16,
        max_snapshots: int = 32,
        rering_every: int = 64,
        seed: int = 0,
    ):
        if num_slots > num_experts:
            raise ValueError("window larger than ring")
        self.num_experts = num_experts
        self.num_slots = num_slots
        self.max_stride = max_stride
        self.reverse_threshold = reverse_threshold
        self.snapshot_every = snapshot_every
        self.rering_every = rering_every
        self.ring = np.arange(num_experts, dtype=np.int32)
        self.pos = 0
        self.step = 0
        self.ema = np.zeros((num_experts,), np.float64)
        self.snapshots: Deque[Tuple[np.ndarray, int]] = deque(maxlen=max_snapshots)
        self._rng = np.random.default_rng(seed)

    # -- window helpers -----------------------------------------------------
    def window_at(self, pos: int) -> np.ndarray:
        idx = (pos + np.arange(self.num_slots)) % self.num_experts
        return self.ring[idx]

    @property
    def window(self) -> np.ndarray:
        return self.window_at(self.pos)

    def _window_score(self, pos: int, demand: np.ndarray) -> float:
        return float(demand[self.window_at(pos)].sum())

    # -- the rotary transform -------------------------------------------------
    def rotate(self, demand: np.ndarray, ema_alpha: float = 0.8) -> RotationDecision:
        """One structured transition given the (predicted) demand vector [E].

        1. cyclical-return check against stored snapshots;
        2. otherwise bounded rotation: choose delta in [-max_stride, max_stride]
           maximizing window demand (ties prefer smaller |delta| — fewer loads).
        """
        self.step += 1
        self.ema = ema_alpha * self.ema + (1.0 - ema_alpha) * demand

        # (a) cyclical return on recurring context — jump only when the
        # remembered window actually serves the current demand better than the
        # present one (prevents ping-ponging between equal-demand snapshots)
        here = self._window_score(self.pos, demand)
        best_snap: Optional[Tuple[float, int]] = None
        for snap_demand, snap_pos in self.snapshots:
            c = cosine(demand, snap_demand)
            if c > self.reverse_threshold and (best_snap is None or c > best_snap[0]):
                if self._window_score(snap_pos, demand) > here + 1e-9:
                    best_snap = (c, snap_pos)
        if best_snap is not None and best_snap[1] != self.pos:
            delta = self._ring_delta(self.pos, best_snap[1], self.num_experts)
            self.pos = best_snap[1]
            return RotationDecision(delta=delta, reverse_jump=True, window=self.window)

        # (b) bounded forward/reverse rotation
        deltas = sorted(range(-self.max_stride, self.max_stride + 1), key=abs)
        best_delta, best_score = 0, -np.inf
        for d in deltas:
            s = self._window_score((self.pos + d) % self.num_experts, demand)
            if s > best_score + 1e-12:
                best_delta, best_score = d, s
        if best_delta == 0 and best_score <= 1e-12 < demand.max():
            # demand lies entirely outside local reach: drift toward the ring
            # position of the hottest expert (bounded by the stride)
            target = int(np.nonzero(self.ring == int(np.argmax(demand)))[0][0])
            dist = (target - self.pos) % self.num_experts
            if dist > self.num_experts // 2:
                best_delta = -min(self.max_stride, self.num_experts - dist)
            else:
                best_delta = min(self.max_stride, dist)
        self.pos = (self.pos + best_delta) % self.num_experts

        # (c) periodic maintenance: snapshot + re-ring by EMA
        if self.step % self.snapshot_every == 0:
            self.snapshots.append((demand.copy(), self.pos))
        if self.step % self.rering_every == 0:
            self._rering()
        return RotationDecision(delta=best_delta, reverse_jump=False, window=self.window)

    def clone(self) -> "RotaryRing":
        """Mutation-isolated copy for transition SIMULATION: prefetch runs the
        next boundary's rotate() on a clone so the speculative plan never
        advances the authoritative ring state (pos/step/EMA/snapshots)."""
        c = RotaryRing(
            self.num_experts,
            self.num_slots,
            max_stride=self.max_stride,
            reverse_threshold=self.reverse_threshold,
            snapshot_every=self.snapshot_every,
            max_snapshots=self.snapshots.maxlen or 32,
            rering_every=self.rering_every,
        )
        c.ring = self.ring.copy()
        c.pos = self.pos
        c.step = self.step
        c.ema = self.ema.copy()
        c.snapshots = deque(self.snapshots, maxlen=self.snapshots.maxlen)
        return c

    @staticmethod
    def _ring_delta(src: int, dst: int, num_experts: int) -> int:
        """Minimal signed rotation taking ``src`` to ``dst`` on the ring.

        A jump across the ring seam (e.g. pos 0 -> pos E-1) is one REVERSE
        step, not E-1 forward steps; ties at exactly half the ring prefer the
        forward direction.
        """
        d = (dst - src) % num_experts
        if d > num_experts // 2:
            d -= num_experts
        return d

    def _rering(self) -> None:
        """Re-sort the ring by demand EMA, keeping the current window's experts
        contiguous at the current position (so re-ringing itself forces no loads)."""
        current = self.window.copy()
        rest = np.setdiff1d(self.ring, current, assume_unique=False)
        rest = rest[np.argsort(-self.ema[rest], kind="stable")]
        new_ring = np.empty_like(self.ring)
        idx = (self.pos + np.arange(self.num_slots)) % self.num_experts
        new_ring[idx] = current
        other_idx = np.setdiff1d(np.arange(self.num_experts), idx, assume_unique=True)
        # place remaining experts clockwise after the window, best EMA first
        order = np.argsort((other_idx - (self.pos + self.num_slots)) % self.num_experts)
        new_ring[other_idx[order]] = rest
        self.ring = new_ring
        # snapshots reference window positions whose contents changed: drop them
        self.snapshots.clear()
