"""Deterministic synthetic token streams (a copy of the reference's
``data/synthetic.py``: the same numpy generators, so a step's batch is the
reference's bit for bit).

Two generators:
  * ``uniform`` — iid tokens (training-throughput runs).
  * ``topic``  — tokens drawn from a latent *topic* that advances along a
    cycle and recurs, inducing recurring router-demand patterns in MoE
    models: the workload the paper's "cyclical return on recurring semantic
    context" targets.

A batch is a function of (spec, step) alone, so a resumed run reads what
an uninterrupted one would have.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "topic"            # "uniform" | "topic"
    num_topics: int = 8
    topic_len: int = 64            # tokens per topic visit
    cycle: Tuple[int, ...] = ()    # explicit topic cycle; () = 0..T-1 loop
    seed: int = 0


def _topic_token_sampler(vocab: int, num_topics: int, seed: int):
    """Each topic owns a sparse preferred-token distribution (Zipf-ish)."""
    rng = np.random.default_rng(seed)
    support = max(16, vocab // num_topics)
    tables = []
    for _ in range(num_topics):
        toks = rng.choice(vocab, size=support, replace=False)
        w = 1.0 / np.arange(1, support + 1)
        tables.append((toks, w / w.sum()))
    return tables


def batch_at_step(spec: SyntheticSpec, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (tokens, labels) int32 [B, S] for a global step; labels
    are the tokens shifted left by one, -1 at the last position."""
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, step]))
    b, s = spec.global_batch, spec.seq_len
    if spec.kind == "uniform":
        tokens = rng.integers(0, spec.vocab_size, (b, s), dtype=np.int64)
    else:
        tables = _topic_token_sampler(spec.vocab_size, spec.num_topics, spec.seed)
        cycle = spec.cycle or tuple(range(spec.num_topics))
        tokens = np.empty((b, s), np.int64)
        for i in range(0, s, spec.topic_len):
            phase = (step * (s // spec.topic_len) + i // spec.topic_len) % len(cycle)
            toks, p = tables[cycle[phase]]
            n = min(spec.topic_len, s - i)
            tokens[:, i:i + n] = rng.choice(toks, size=(b, n), p=p)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1                      # the last position has no target
    return tokens.astype(np.int32), labels.astype(np.int32)


def stream(spec: SyntheticSpec, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at_step(spec, step)
        step += 1
