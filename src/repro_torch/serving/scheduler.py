"""Request scheduler: admission, continuous-batching slot assignment, deadlines.

The port's copy of ``repro/serving/scheduler.py`` (pure Python and numpy).

Straggler mitigation (serving-side): every admission estimates completion time
from the engine's observed per-token latency; requests that cannot meet their
deadline are rejected up-front (or, if already running and past deadline,
truncated at the next step boundary) instead of dragging the whole batch — a
slow request in a synchronous decode batch is the serving analog of a straggler
node.

The scheduler also owns the per-ROW speculative-length policy: each slot's
draft accept rate (fed back by the engine after every window) adapts how far
that row may self-draft, so one misrouting row throttles only itself.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_new: int
    deadline_s: Optional[float] = None # relative to submission
    submitted_at: float = 0.0          # arrival
    # sampled serving: the request's PRNG stream seed (None = engine default).
    # Request-intrinsic — never derived from uid/slot — so the stream is
    # reproducible regardless of batching or admission order.
    seed: Optional[int] = None
    # filled by the engine
    output: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    truncated: bool = False
    reject_reason: str = ""            # why submit refused it (rejected only)
    # lifecycle timestamps (same clock as submitted_at): admission, first
    # emitted token (TTFT = first_token_at - submitted_at), every token
    # commit (inter-token latency percentiles), completion
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    token_times: List[float] = field(default_factory=list)
    finished_at: float = 0.0


class Scheduler:
    def __init__(self, num_slots: int, *, est_tok_s: float = 20.0,
                 est_prefill_tok_s: Optional[float] = None,
                 spec_cap: int = 8, spec_low: float = 0.7,
                 spec_high: float = 0.95,
                 max_prompt_len: Optional[int] = None):
        self.num_slots = num_slots
        # prompts longer than the engine's KV capacity are rejected at
        # submit time (the prefill buckets clamp to the cache, so an
        # over-long prompt cannot be admitted without corrupting its row)
        self.max_prompt_len = max_prompt_len
        self.queue: List = []
        self.running: Dict[int, Request] = {}       # slot -> request
        self.free_slots = list(range(num_slots))
        self.est_tok_s = est_tok_s
        # separate prefill-rate estimate: admission used to assume prefill is
        # exactly 4x the decode rate, which the engine never corrected; the
        # serving engine now feeds measured prefill tok/s into this EMA. The
        # 4x prior survives only as the cold-start value.
        self.est_prefill_tok_s = (
            est_prefill_tok_s if est_prefill_tok_s is not None else 4 * est_tok_s
        )
        # per-ROW learned speculative lengths: each slot tracks an EMA of its
        # draft accept rate and adapts how far the engine may self-draft for
        # that row — rows whose routing keeps missing residency shrink toward
        # single-token decode, rows that accept everything grow toward the cap
        self.spec_cap = max(1, spec_cap)
        self.spec_low = spec_low
        self.spec_high = spec_high
        self._spec_len: Dict[int, int] = {}
        self._accept_ema: Dict[int, float] = {}
        self.rejected: List[Request] = []
        self.completed: List[Request] = []
        self._uid = itertools.count()

    def submit(self, prompt: np.ndarray, max_new: int, now: float,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None) -> Request:
        req = Request(next(self._uid), np.asarray(prompt, np.int32), max_new,
                      deadline_s, submitted_at=now, seed=seed)
        too_long = (
            self.max_prompt_len is not None
            and len(prompt) > self.max_prompt_len
        )
        est = len(prompt) / self.est_prefill_tok_s + max_new / self.est_tok_s
        if too_long or (deadline_s is not None and est > deadline_s):
            req.done = True
            req.truncated = True
            req.reject_reason = (
                f"prompt length {len(prompt)} exceeds KV capacity "
                f"{self.max_prompt_len}" if too_long
                else f"deadline {deadline_s}s infeasible (est {est:.3f}s)"
            )
            self.rejected.append(req)
            return req
        heapq.heappush(self.queue, (req.deadline_s or float("inf"), req.uid, req))
        return req

    def admit(self, now: float, pool=None) -> List[Request]:
        """Fill free slots from the queue (earliest deadline first).

        With a ``pool`` (`repro_torch.serving.kv_pool.KVPagePool`), admission is
        driven by PAGE-POOL PRESSURE, not batch geometry: each admit reserves
        the worst case — pages for the prompt, the full declared output
        budget (the forecast the EMAs refine only tells us the *expected*
        finish; the reservation must cover the tail), plus ``spec_cap - 1``
        speculative headroom (a window writes all K drafted positions before
        per-row acceptance clamps to the budget) — and stops when the
        head-of-line request doesn't fit, preserving EDF order. Lazy physical
        allocation against that reservation can then never fail mid-window,
        and early finishes hand their unused pages to the next arrival."""
        admitted = []
        while self.free_slots and self.queue:
            _, _, req = self.queue[0]
            if pool is not None:
                need = pool.pages_for(
                    len(req.prompt) + req.max_new + self.spec_cap - 1
                )
                if not pool.reserve(req.uid, need):
                    break
            heapq.heappop(self.queue)
            req.slot = self.free_slots.pop(0)
            req.admitted_at = now
            # a never-seen slot joins at the group's learned drafting pace:
            # slots keep their per-row spec length across requests, but under
            # continuous batching a cold slot starting at 1 would drag the
            # whole window (K = min over live rows) back to single-token
            # decode on every join. Misrouting still halves it within a
            # window or two.
            if req.slot not in self._spec_len and self._spec_len:
                self._spec_len[req.slot] = max(self._spec_len.values())
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

    def step_done(self, slot: int, token: int, now: float, eos: Optional[int] = None) -> None:
        req = self.running[slot]
        req.output.append(int(token))
        if not req.first_token_at:
            req.first_token_at = now
        req.token_times.append(now)
        over_deadline = (
            req.deadline_s is not None and now - req.submitted_at > req.deadline_s
        )
        if len(req.output) >= req.max_new or (eos is not None and token == eos) or over_deadline:
            req.done = True
            req.truncated = over_deadline and len(req.output) < req.max_new
            req.finished_at = now
            self.completed.append(req)
            del self.running[slot]
            self.free_slots.append(slot)
            self.free_slots.sort()

    def observe_rate(self, tok_s: float) -> None:
        self.est_tok_s = 0.9 * self.est_tok_s + 0.1 * tok_s

    def observe_prefill_rate(self, tok_s: float) -> None:
        """Measured prefill tokens/s feedback (engine calls this per prefill)."""
        self.est_prefill_tok_s = 0.9 * self.est_prefill_tok_s + 0.1 * tok_s

    @staticmethod
    def prefill_bucket(lengths: List[int], cache_len: int) -> int:
        """Admission bucket for one prefill group: the power-of-two length
        (min 16, clamped to the cache) covering every admitted prompt, so the
        whole group runs through ONE shared compiled prefill program instead
        of one batch-1 program launch per request. The scheduler owns the
        choice so the engine's compile cache is keyed purely on bucket."""
        m = max(lengths)
        return min(max(16, 1 << (m - 1).bit_length()), cache_len)

    # -- per-row speculative lengths --------------------------------------
    def spec_len(self, slot: int) -> int:
        """How far the engine may self-draft for this row (learned, >= 1)."""
        return self._spec_len.get(slot, 1)

    def observe_accept(self, slot: int, drafted: int, accepted: int) -> None:
        """Fold one window's accept outcome for ``slot`` into its EMA and
        adapt the row's speculative length: below ``spec_low`` the window
        halves (a misrouting row should stop wasting drafted compute and let
        rotation catch up every token), above ``spec_high`` it grows one step
        toward ``spec_cap``. Deterministic — no wall clock involved — so
        serving tests can drive it with a fake clock.
        """
        if drafted <= 0:
            return
        rate = accepted / drafted
        ema = self._accept_ema.get(slot)
        ema = rate if ema is None else 0.5 * ema + 0.5 * rate
        self._accept_ema[slot] = ema
        cur = self.spec_len(slot)
        if ema < self.spec_low:
            self._spec_len[slot] = max(1, cur // 2)
        elif ema > self.spec_high:
            self._spec_len[slot] = min(self.spec_cap, cur + 1)

    @property
    def idle(self) -> bool:
        return not self.running and not self.queue
