"""Hidden-state-guided residency prediction (pre-gating).

Layer l+1's demand is predicted *before* it executes by pushing layer l's
post-attention hidden state through layer l+1's router matrix — a cheap [D, E]
GEMV — and EMA-smoothing across steps. This is the natural reading of the
patent's "hidden-state-guided residency decisions": the signal is generated
during execution, not from static configuration.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def host_topk_route(
    logits: np.ndarray, k: int, *, normalize: bool = True
) -> "tuple[np.ndarray, np.ndarray]":
    """Host-side router: logits [T, E] -> (ids [T, k] int32, weights [T, k] f32).

    Tie-breaking is lowest-index-wins (``kind="stable"`` on the descending
    sort), matching the ``topk_gate`` kernel and its plain version so the
    host and device routing paths pick identical experts on tied probabilities.
    """
    probs = softmax(np.asarray(logits, np.float32), axis=-1)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k].astype(np.int32)
    weights = np.take_along_axis(probs, ids, axis=-1)
    if normalize:
        weights = weights / np.maximum(weights.sum(-1, keepdims=True), 1e-9)
    return ids, weights


class DemandPredictor:
    """Per-model predictor over ``num_layers`` MoE layers.

    ``routers`` holds each MoE layer's router matrix [D, E] (host copies).
    ``predict(l, h)`` estimates the demand of layer ``l`` from hidden state
    ``h`` [B, D] taken at the *previous* layer's output.
    """

    def __init__(self, routers: List[np.ndarray], ema: float = 0.8):
        self.routers = [np.asarray(r, np.float32) for r in routers]
        self.ema = ema
        e = self.routers[0].shape[1]
        self.smoothed = [np.full((e,), 1.0 / e, np.float64) for _ in self.routers]
        # freshest raw pre-gating sample per layer (pre-EMA): the prefetch
        # planner steers on this — one step stale, but far closer to the next
        # step's actual routing than the heavily damped EMA
        self.last_sample = [np.full((e,), 1.0 / e, np.float64) for _ in self.routers]

    @property
    def num_layers(self) -> int:
        return len(self.routers)

    def predict(self, layer: int, h: Optional[np.ndarray]) -> np.ndarray:
        """Demand vector [E] for ``layer``; h [B, D] or None (cold start)."""
        if h is None:
            return self.smoothed[layer].copy()
        logits = np.asarray(h, np.float32) @ self.routers[layer]      # [B, E]
        return self.update(layer, softmax(logits, axis=-1).mean(axis=0))

    def update(self, layer: int, demand: np.ndarray) -> np.ndarray:
        """EMA-fold an externally computed demand sample [E] (the fused decode
        step's on-device router GEMM) and return the smoothed demand — the
        host half of ``predict`` when the GEMM already ran on device."""
        demand = np.asarray(demand, np.float64)
        self.last_sample[layer] = demand.copy()
        self.smoothed[layer] = self.ema * self.smoothed[layer] + (1 - self.ema) * demand
        return self.smoothed[layer].copy()

    def fold_window(
        self,
        layer: int,
        ids: np.ndarray,         # [K, T, k] routed ids, one row per window step
        weights: np.ndarray,     # [K, T, k]
        demands: np.ndarray,     # [K, E] on-device demand samples per step
    ) -> np.ndarray:
        """Demand aggregated over a speculative window: fold every accepted
        step's (observed routing, predicted demand) pair into the EMA in step
        order, returning the smoothed demand AFTER each step [K, E].

        One call per layer per window replaces 2K ``observe``/``update`` calls
        while staying bit-identical to applying the same K steps one token at
        a time — the invariant the window-deferred-rotation property tests
        pin down (residency transitions consume row ``s`` exactly where a
        sequential engine would have used step ``s``'s smoothed demand).
        """
        out = np.empty((ids.shape[0], self.routers[layer].shape[1]), np.float64)
        for s in range(ids.shape[0]):
            self.observe(layer, ids[s], weights[s])
            out[s] = self.update(layer, demands[s])
        return out

    def next_layer_routers(self) -> np.ndarray:
        """Stacked router matrices [L, D, E] with R[l] = router of layer
        (l+1) % L, so ``softmax(h_l @ R[l])`` is layer l+1's demand predicted
        from layer l's hidden — uploaded once and consumed inside the fused
        decode step (pre-gating moved on-device)."""
        n = self.num_layers
        return np.stack([self.routers[(l + 1) % n] for l in range(n)])

    def observe(self, layer: int, ids: np.ndarray, weights: np.ndarray) -> None:
        """Fold actually-routed experts back into the smoothed demand (feedback
        for when pre-gating and true routing diverge)."""
        e = self.routers[layer].shape[1]
        actual = np.zeros((e,), np.float64)
        np.add.at(actual, ids.reshape(-1), weights.reshape(-1).astype(np.float64))
        s = actual.sum()
        if s > 0:
            actual /= s
            self.smoothed[layer] = 0.5 * self.smoothed[layer] + 0.5 * actual

    def forecast(self, layer: int) -> np.ndarray:
        """Current smoothed demand [E] — the prefetch planner's forecast of
        the NEXT boundary's transition input. The boundary will fold a fresh
        on-device sample into this EMA before transitioning; speculation uses
        the pre-fold value, which is why a prefetched slot can mispredict and
        why the commit pass re-checks every one."""
        return self.smoothed[layer].copy()

    def steer_signal(self, layer: int) -> np.ndarray:
        """Freshest raw pre-gating sample [E] for predictive slot steering."""
        return self.last_sample[layer].copy()

    def top_experts(self, layer: int, k: int) -> np.ndarray:
        return np.argsort(-self.smoothed[layer])[:k].astype(np.int32)
