"""Token samplers and speculative accept rules (the counterpart of
``repro/serving/sampler.py``, numpy only).

``Sampler`` is the host reference for the on-device warp in
``repro_torch.models.sampling`` (the same kept set: top-k ties go to the
lower index, top-p sorts descending with a stable sort). ``greedy_accept``
and ``stochastic_accept`` decide how many drafted tokens a speculative
window commits; ``stochastic_accept`` is the leftover-distribution rejection
rule (Leviathan et al.): accept drafted token t with probability
``min(1, q(t)/p(t))`` and resample the first rejection from
``normalize(max(q - p, 0))``. A self-drafting engine passes the same
distributions for p and q, so it accepts every position and rejection
comes only from residency misses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def greedy_accept(draft: np.ndarray, verify: np.ndarray) -> np.ndarray:
    """Greedy speculative accept rule: per-row length of the agreeing prefix.

    ``draft``/``verify`` are [K, B] token ids: the drafted window and the
    verifier's argmaxes for the same positions. A position commits only if it
    and every earlier position agree (a disagreement invalidates everything
    drafted after it). Self-drafting with identical weights verifies against
    its own argmaxes, so this accepts the full window and rejection comes
    only from residency misses; the call is the plug point for a separate
    draft model. Returns accepted counts [B] in ``0..K``.
    """
    agree = np.cumprod(draft == verify, axis=0, dtype=np.int32)     # [K, B]
    return agree.sum(axis=0).astype(np.int32)


def stochastic_accept(
    draft: np.ndarray,          # [K, B] drafted token ids
    draft_probs: np.ndarray,    # [K, B, V] draft distributions p
    verify_probs: np.ndarray,   # [K, B, V] verifier distributions q
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stochastic speculative acceptance (leftover-distribution rejection
    sampling, Leviathan et al.): accept drafted token t with probability
    ``min(1, q(t)/p(t))``; at the first rejection draw the replacement from
    ``normalize(max(q - p, 0))``.

    Returns ``(accepted [B], resampled [B])``: per-row accepted counts in
    ``0..K`` and, for rows with ``accepted < K``, the leftover-resampled
    replacement token at the first rejected position (``-1`` for rows that
    accepted the whole window). Committing ``accepted`` drafted tokens plus
    the replacement makes each emitted position exactly ``q``-distributed —
    the property the chi-squared tests verify.

    Self-drafting callers pass ``draft_probs is verify_probs``: every ratio is
    exactly 1, acceptance is certain, and the resample path is dormant (their
    rejections come from residency misses; the caller composes the two caps
    with a per-row ``min``).
    """
    k, b = draft.shape
    p = np.asarray(draft_probs, np.float64)                     # [K, B, V]
    q = np.asarray(verify_probs, np.float64)
    p_tok = np.take_along_axis(p, draft[..., None], axis=-1)[..., 0]   # [K, B]
    q_tok = np.take_along_axis(q, draft[..., None], axis=-1)[..., 0]
    # p(t) > 0 whenever t was genuinely drawn from p; guard anyway
    ratio = np.where(p_tok > 0, q_tok / np.maximum(p_tok, 1e-300), 0.0)
    u = rng.random((k, b))
    reject = u >= np.minimum(1.0, ratio)                        # [K, B]
    any_rej = reject.any(axis=0)
    accepted = np.where(any_rej, reject.argmax(axis=0), k).astype(np.int32)
    resampled = np.full((b,), -1, np.int32)
    rows = np.flatnonzero(any_rej)
    if rows.size:
        leftover = np.maximum(q[accepted[rows], rows] - p[accepted[rows], rows],
                              0.0)                              # [R, V]
        z = leftover.sum(axis=-1, keepdims=True)
        # z == 0 only if p >= q everywhere, i.e. p == q — then a rejection is
        # impossible up to float underflow; fall back to q itself
        leftover = np.where(z > 0, leftover, q[accepted[rows], rows])
        leftover /= leftover.sum(axis=-1, keepdims=True)
        cum = np.cumsum(leftover, axis=-1)
        u2 = rng.random((rows.size, 1))
        resampled[rows] = np.minimum(
            (cum < u2).sum(axis=-1), leftover.shape[-1] - 1
        ).astype(np.int32)
    return accepted, resampled


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0        # 0 = greedy
    top_k: int = 0                  # 0 = off
    top_p: float = 1.0
    seed: int = 0


class Sampler:
    def __init__(self, cfg: SamplerConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def warp(self, logits: np.ndarray) -> np.ndarray:
        """logits [B, V] -> warped probabilities [B, V] (zeros off-support).

        The host reference for ``repro_torch.models.sampling.warp_probs``: top-k
        keeps exactly ``top_k`` candidates with ties broken toward the LOWER
        index (the ``lax.top_k`` convention — a plain threshold mask would
        keep every tied candidate and sample a wider distribution than the
        device path), top-p keeps tokens while the cumulative mass before
        them is < p under a STABLE descending sort.
        """
        c = self.cfg
        x = logits.astype(np.float64) / c.temperature
        v = x.shape[-1]
        if 0 < c.top_k < v:
            order = np.argsort(-x, axis=-1, kind="stable")      # [B, V]
            keep = np.zeros_like(x, bool)
            np.put_along_axis(keep, order[:, : c.top_k], True, axis=-1)
            x = np.where(keep, x, -np.inf)
        p = np.exp(x - x.max(axis=-1, keepdims=True))
        p /= p.sum(axis=-1, keepdims=True)
        if c.top_p < 1.0:
            order = np.argsort(-p, axis=-1, kind="stable")
            sorted_p = np.take_along_axis(p, order, axis=-1)
            cum = np.cumsum(sorted_p, axis=-1)
            keep_sorted = cum - sorted_p < c.top_p
            keep = np.zeros_like(p, bool)
            np.put_along_axis(keep, order, keep_sorted, axis=-1)
            p = np.where(keep, p, 0.0)
            p /= p.sum(axis=-1, keepdims=True)
        return p

    def __call__(self, logits: np.ndarray) -> np.ndarray:
        """logits [B, V] -> tokens [B] (batched inverse-CDF draw: one uniform
        per row against the warped CDF — no per-row host loop)."""
        c = self.cfg
        if c.temperature <= 0.0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        p = self.warp(logits)
        cum = np.cumsum(p, axis=-1)
        u = self.rng.random((p.shape[0], 1))
        return np.minimum(
            (cum < u).sum(axis=-1), p.shape[-1] - 1
        ).astype(np.int32)
