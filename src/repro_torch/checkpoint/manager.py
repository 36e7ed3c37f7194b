"""Checkpoint manager: async save, retention, resume from the latest
committed step (the reference's ``checkpoint/manager.py``).

The snapshot to host is taken on the caller's thread (a consistent view of
the step's tensors), the disk write on a worker thread, overlapping the
next steps. Layout: ``{dir}/step_{N:08d}/{arrays.npz, meta.json}`` and a
``COMMIT`` marker written last: a crash mid-save leaves no COMMIT, and
restoring skips that directory.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.serializer import load_tree, tree_to_arrays


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def step_dir(self, step: int) -> str:
        """Step N's directory (committed or not)."""
        return os.path.join(self.directory, f"step_{step:08d}")

    def existing_steps(self) -> List[int]:
        """Committed steps, ascending."""
        steps = []
        if not os.path.isdir(self.directory):
            return steps
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "COMMIT")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state: Any, meta: Optional[Dict] = None) -> None:
        """Snapshot ``state`` to host now, write it (on a worker thread when
        ``async_save``), then mark it committed and drop the oldest past
        ``keep``."""
        self.wait()
        arrays = tree_to_arrays(state)
        meta = {**(meta or {}), "step": step}

        def write() -> None:
            path = self.step_dir(step)
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, "arrays.npz"), **arrays)
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)
            with open(os.path.join(path, "COMMIT"), "w") as f:
                f.write("ok")
            self._gc()

        if not self.async_save:
            write()
            return

        def run() -> None:
            try:
                write()
            except BaseException as exc:   # re-raised by wait() on the caller's thread
                self._error = exc

        self._pending = threading.Thread(target=run, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Join the pending write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def _gc(self) -> None:
        steps = self.existing_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any, Dict]]:
        """(step, state, meta) of the newest committed checkpoint, ``template``
        filled with it (``serializer.arrays_to_tree``), or None."""
        steps = self.existing_steps()
        if not steps:
            return None
        state, meta = load_tree(self.step_dir(steps[-1]), template)
        return steps[-1], state, meta
