"""Expert <-> slot lookup table (the patent's "lookup-table mapping structure").

The LUT is the indirection that lets compiled compute address the *rotating*
physical slot buffer: ``lut[expert] -> slot`` with ``MISS = num_slots`` pointing
at the trailing zero slot. The inverse map ``slot -> expert`` drives eviction
bookkeeping. Host-side numpy; the device copy is refreshed on rotation.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np


class SlotLUT:
    # device copies that sync incrementally off this table: the per-layer [E]
    # int32 array and the per-segment stacked LUT plane (one row per rep)
    _consumers: Tuple[str, ...] = ("device", "stacked")

    def __init__(self, num_experts: int, num_slots: int):
        self.num_experts = num_experts
        self.num_slots = num_slots
        self.miss = num_slots                       # sentinel: trailing zero slot
        self.e2s = np.full((num_experts,), self.miss, np.int32)
        self.s2e = np.full((num_slots,), -1, np.int32)
        # incremental-device-sync bookkeeping: ``version`` counts mutations;
        # per-CONSUMER dirty sets hold expert ids whose e2s entry changed since
        # that consumer's last ``take_dirty``. Two device copies track this LUT
        # independently — the per-layer [E] array (consumer "device") and the
        # per-segment stacked LUT plane (consumer "stacked") — so each patches
        # only the entries IT hasn't absorbed yet instead of re-uploading [E]
        # per layer per step.
        self.version = 0
        self._dirty: Dict[str, set] = {}

    # -- queries ----------------------------------------------------------
    def slot_of(self, expert: int) -> int:
        return int(self.e2s[expert])

    def expert_in(self, slot: int) -> int:
        return int(self.s2e[slot])

    def is_resident(self, expert: int) -> bool:
        return self.e2s[expert] != self.miss

    @property
    def resident_experts(self) -> np.ndarray:
        return np.flatnonzero(self.e2s != self.miss)

    @property
    def free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.s2e < 0)]

    def as_array(self) -> np.ndarray:
        """Device-uploadable [E] int32 (missing experts -> miss sentinel)."""
        return self.e2s.copy()

    def dirty_count(self, consumer: str = "device") -> int:
        """Number of e2s entries mutated since ``consumer``'s last
        ``take_dirty`` — lets the residency manager pick patch vs full
        re-upload without consuming (or materializing) the dirty set."""
        return len(self._dirty.get(consumer, ()))

    def take_dirty(self, consumer: str = "device") -> np.ndarray:
        """Expert ids mutated since ``consumer``'s previous call (sorted, then
        cleared for that consumer only — the other device copies keep their
        own backlog)."""
        d = self._dirty.get(consumer)
        if not d:
            return np.empty((0,), np.int64)
        idx = np.fromiter(sorted(d), np.int64, len(d))
        d.clear()
        return idx

    def _mark_dirty(self, expert: int) -> None:
        for consumer in self._consumers:
            self._dirty.setdefault(consumer, set()).add(int(expert))

    def clone(self) -> "SlotLUT":
        """Mutation-isolated copy for transition SIMULATION (the prefetch
        predictor runs the next boundary's placement on a clone so speculative
        planning never touches the authoritative table or its dirty sets)."""
        c = SlotLUT(self.num_experts, self.num_slots)
        c.e2s = self.e2s.copy()
        c.s2e = self.s2e.copy()
        return c

    # -- updates ----------------------------------------------------------
    def assign(self, expert: int, slot: int) -> int:
        """Bind expert -> slot, evicting any previous occupant. Returns evicted
        expert id or -1."""
        if not (0 <= slot < self.num_slots):
            raise ValueError(f"slot {slot} out of range [0,{self.num_slots})")
        evicted = int(self.s2e[slot])
        if evicted >= 0:
            self.e2s[evicted] = self.miss
            self._mark_dirty(evicted)
        prev_slot = int(self.e2s[expert])
        if prev_slot != self.miss:
            self.s2e[prev_slot] = -1
        self.e2s[expert] = slot
        self.s2e[slot] = expert
        self._mark_dirty(expert)
        self.version += 1
        return evicted

    def evict(self, expert: int) -> None:
        slot = int(self.e2s[expert])
        if slot != self.miss:
            self.s2e[slot] = -1
            self.e2s[expert] = self.miss
            self._mark_dirty(expert)
            self.version += 1

    def check_consistent(self) -> None:
        """Invariant: e2s and s2e are mutually inverse partial bijections."""
        for s in range(self.num_slots):
            e = self.s2e[s]
            if e >= 0:
                assert self.e2s[e] == s, (s, e)
        for e in range(self.num_experts):
            s = self.e2s[e]
            if s != self.miss:
                assert self.s2e[s] == e, (e, s)
        res = self.e2s[self.e2s != self.miss]
        assert len(np.unique(res)) == len(res), "two experts share a slot"
