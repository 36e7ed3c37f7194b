"""Input pipeline with background prefetch (the reference's
``data/pipeline.py`` on one device).

``Loader`` makes each step's batch ``depth`` steps ahead on a worker
thread. On a card the worker pins the batch in host memory and the
consumer copies it with ``non_blocking``, so step N+1's host-to-device copy
overlaps step N's compute (the data-side analog of the residency engine's
double buffering).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import torch

from repro_torch.data.synthetic import SyntheticSpec, batch_at_step


class Loader:
    """Iterates (step, tokens [B, S], labels [B, S]) int32 on ``device`` from
    ``start_step`` on. Close it (or use it as a context manager) to stop
    the worker."""

    def __init__(self, spec: SyntheticSpec, device="cuda", depth: int = 2,
                 start_step: int = 0):
        self.spec = spec
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        self._pin = self.device.type == "cuda"
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(start_step,), daemon=True)
        self._thread.start()

    def _host(self, a) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory() if self._pin else t

    def _worker(self, step: int) -> None:
        while not self._stop.is_set():
            try:
                item = (step, *(self._host(a) for a in batch_at_step(self.spec, step)))
            except Exception as exc:       # surfaced by __next__
                item = (step, exc, None)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[2] is None:
                return
            step += 1

    def __iter__(self) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        return self

    def __next__(self) -> Tuple[int, torch.Tensor, torch.Tensor]:
        step, tokens, labels = self._q.get()
        if labels is None:
            raise RuntimeError(f"data worker failed at step {step}") from tokens
        return (step, tokens.to(self.device, non_blocking=True),
                labels.to(self.device, non_blocking=True))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "Loader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
