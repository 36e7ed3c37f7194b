"""Speculative accept rules (the counterpart of ``repro/serving/sampler.py``).

Only the greedy rule is here: sampled decode is not ported yet.
"""
from __future__ import annotations

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
