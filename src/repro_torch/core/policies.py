"""Residency policies: rotary (the paper) vs LRU / static / full baselines.

Interface per MoE layer:
  * ``prepare(demand)``   — proactive transition BEFORE the layer executes,
    driven by the (predicted) demand vector. Returns expert->slot loads to issue
    off the critical path (hidden behind compute when bandwidth allows).
  * ``on_miss(expert)``   — reactive handling when a routed expert is not
    resident: a blocking load (LRU) or None = leave to host compute (paper's
    n-cpu-moe path).
  * ``touch(experts)``    — usage feedback.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.lut import SlotLUT
from repro_torch.core.rotation import RotaryRing

Load = Tuple[int, int]   # (expert, slot)


class ResidencyPolicy:
    name = "base"
    # True for policies whose miss handling mutates residency MID-step (they
    # need routed ids on host before the next layer runs, forcing the engine's
    # per-layer sync walk instead of the device-resident hot path)
    needs_sync_resolve = False
    # >0 enables predictive steering (see RotaryPolicy): up to this many of the
    # coldest resident slots may be retargeted to hot off-window experts per
    # transition. Set ONLY via the residency manager's prefetch mode — the
    # synchronous baseline keeps 0, so its transitions are byte-identical to
    # every prior PR.
    prefetch_margin = 0

    def __init__(self, num_experts: int, num_slots: int):
        self.lut = SlotLUT(num_experts, num_slots)

    def prepare(
        self, demand: np.ndarray, steer_demand: Optional[np.ndarray] = None
    ) -> List[Load]:
        return []

    def simulate_prepare(
        self, demand: np.ndarray, steer_demand: Optional[np.ndarray] = None
    ) -> List[Load]:
        """The loads the NEXT ``prepare(demand)`` would issue, WITHOUT mutating
        this policy — the prefetch planner runs it on clones so speculative
        uploads never advance the authoritative LUT/ring state."""
        sim = copy.copy(self)
        sim.lut = self.lut.clone()
        return sim.prepare(demand, steer_demand)

    def on_miss(self, expert: int) -> Optional[Load]:
        return None

    def touch(self, experts: np.ndarray) -> None:
        pass

    # helper: place `experts` into slots, evicting non-members of `keep`
    def _place(self, experts: List[int], keep: np.ndarray) -> List[Load]:
        loads: List[Load] = []
        keep_set = set(int(e) for e in keep)
        evictable = [
            s for s in range(self.lut.num_slots)
            if self.lut.s2e[s] >= 0 and int(self.lut.s2e[s]) not in keep_set
        ]
        free = self.lut.free_slots + evictable
        for e in experts:
            if self.lut.is_resident(e):
                continue
            if not free:
                break
            slot = free.pop(0)
            self.lut.assign(int(e), slot)
            loads.append((int(e), slot))
        return loads


class FullPolicy(ResidencyPolicy):
    """Everything resident (num_slots == num_experts): the paper's 'whole
    warehouse on the loading dock' strawman; also the EP-sharded pod default."""

    name = "full"

    def __init__(self, num_experts: int, num_slots: int):
        super().__init__(num_experts, num_experts)
        self.initial_loads = [(e, e) for e in range(num_experts)]
        for e, s in self.initial_loads:
            self.lut.assign(e, s)


class StaticPolicy(ResidencyPolicy):
    """Fixed top-demand resident set chosen at startup, never rotated."""

    name = "static"

    def __init__(self, num_experts: int, num_slots: int):
        super().__init__(num_experts, num_slots)
        self._initialized = False

    def prepare(
        self, demand: np.ndarray, steer_demand: Optional[np.ndarray] = None
    ) -> List[Load]:
        if self._initialized:
            return []
        self._initialized = True
        top = np.argsort(-demand)[: self.lut.num_slots]
        return self._place([int(e) for e in top], top)


class LruPolicy(ResidencyPolicy):
    """Classic one-directional eviction: no prefetch; a miss blocks on a load
    that replaces the least-recently-used slot."""

    name = "lru"
    needs_sync_resolve = True

    def __init__(self, num_experts: int, num_slots: int):
        super().__init__(num_experts, num_slots)
        self.clock = 0
        self.last_used = np.full((num_experts,), -1, np.int64)

    def touch(self, experts: np.ndarray) -> None:
        self.clock += 1
        self.last_used[np.asarray(experts, np.int64)] = self.clock

    def on_miss(self, expert: int) -> Optional[Load]:
        free = self.lut.free_slots
        if free:
            slot = free[0]
        else:
            res = self.lut.resident_experts
            victim = int(res[np.argmin(self.last_used[res])])
            slot = self.lut.slot_of(victim)
        self.lut.assign(expert, slot)
        self.touch(np.array([expert]))
        return (expert, slot)


class RotaryPolicy(ResidencyPolicy):
    """The paper's policy: ring-ordered experts, bounded cyclic window rotation,
    hidden-state-guided (demand-vector) transitions, cyclical return on
    recurring context. Misses fall through to host compute (prefetch exists to
    make them rare), keeping loads OFF the critical path."""

    name = "rotary"

    def __init__(
        self,
        num_experts: int,
        num_slots: int,
        *,
        rotation_stride: int = 4,
        reverse_threshold: float = 0.85,
        host_compute_misses: bool = True,
        seed: int = 0,
    ):
        super().__init__(num_experts, num_slots)
        self.ring = RotaryRing(
            num_experts,
            num_slots,
            max_stride=rotation_stride,
            reverse_threshold=reverse_threshold,
            seed=seed,
        )
        self.host_compute_misses = host_compute_misses
        self.last_decision = None

    def prepare(
        self, demand: np.ndarray, steer_demand: Optional[np.ndarray] = None
    ) -> List[Load]:
        decision = self.ring.rotate(demand)
        self.last_decision = decision
        # the ring rotates on the long-horizon EMA; steering retargets slots
        # on the FRESH pre-gating sample when one is supplied — replay is
        # billed per step-with-a-miss, so the steering signal must predict the
        # next step's routing, not the running average
        target = self._steer_window(
            decision.window, demand if steer_demand is None else steer_demand
        )
        return self._place([int(e) for e in target], target)

    def _steer_window(self, window: np.ndarray, demand: np.ndarray) -> np.ndarray:
        """Predictive steering (prefetch mode only): swap up to
        ``prefetch_margin`` of the window's coldest experts for strictly-hotter
        experts the bounded ring rotation cannot reach. This is what converts
        predicted misses into hits — the ring keeps hot experts CONTIGUOUS
        only in aggregate, and a miss costs a host GEMM + suffix replay, far
        more than the int4 upload a swap costs. Deterministic: stable argsort,
        expert-id tie-breaks. With margin 0 (the synchronous baseline) the ring
        window passes through untouched."""
        margin = self.prefetch_margin
        if margin <= 0:
            return window
        members = [int(e) for e in window]
        member_set = set(members)
        order = np.argsort(-demand, kind="stable")
        hot = [
            int(e) for e in order
            if int(e) not in member_set and demand[int(e)] > 0.0
        ][:margin]
        if not hot:
            return window
        cold = sorted(members, key=lambda e: (demand[e], e))
        swapped = list(members)
        ci = 0
        for h in hot:                        # hottest missing vs coldest held
            victim = cold[ci]
            if demand[victim] >= demand[h]:
                break
            swapped[swapped.index(victim)] = h
            ci += 1
        return np.asarray(swapped, np.int32)

    def simulate_prepare(
        self, demand: np.ndarray, steer_demand: Optional[np.ndarray] = None
    ) -> List[Load]:
        sim = copy.copy(self)
        sim.ring = self.ring.clone()
        sim.lut = self.lut.clone()
        return sim.prepare(demand, steer_demand)

    def on_miss(self, expert: int) -> Optional[Load]:
        if self.host_compute_misses:
            return None                      # host executes it (n-cpu-moe analog)
        free = self.lut.free_slots
        if not free:
            return None
        slot = free[0]
        self.lut.assign(expert, slot)
        return (expert, slot)


def make_policy(mode: str, num_experts: int, num_slots: int, rescfg=None, seed: int = 0
                ) -> ResidencyPolicy:
    if mode == "full":
        return FullPolicy(num_experts, num_experts)
    if mode == "static":
        return StaticPolicy(num_experts, num_slots)
    if mode == "lru":
        return LruPolicy(num_experts, num_slots)
    if mode == "rotary":
        kw: Dict = {}
        if rescfg is not None:
            kw = dict(
                rotation_stride=rescfg.rotation_stride,
                reverse_threshold=rescfg.reverse_threshold,
                host_compute_misses=rescfg.host_compute_misses,
            )
        return RotaryPolicy(num_experts, num_slots, seed=seed, **kw)
    raise ValueError(f"unknown residency mode {mode!r}")
