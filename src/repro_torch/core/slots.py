"""Device slot buffers: the rotating device-resident expert store.

The counterpart of ``repro/core/slots.py`` for unquantized stores (the int8
and int4 formats are not ported yet). One ``SlotStore`` per MoE layer holds
``num_slots + 1`` expert weight sets per weight tensor, ``[S+1, D, F]`` on the
device; the trailing slot stays all-zeros and backs the LUT's MISS sentinel,
so the grouped-matmul kernel needs no branch for a miss.

An upload gathers the experts' rows from the host warehouse (pinned memory)
into a pinned staging tensor, copies it to the device without blocking, and
lands it with ONE ``index_copy_`` per weight tensor, all on the current
stream. Stream order is what keeps it safe: a launch queued earlier reads
the old slot contents before the copy overwrites them, so the engine rotates
strictly after the step (and any replay) that reads the previous residency.
PyTorch's pinned-memory allocator keeps each staging block alive until its
copy has run.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def gather_rows(host: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """host[rows] into a fresh staging tensor, pinned when a card is present."""
    idx = torch.as_tensor(np.asarray(rows, np.int64))
    out = torch.empty((len(idx),) + tuple(host.shape[1:]), dtype=host.dtype,
                      pin_memory=torch.cuda.is_available())
    torch.index_select(host, 0, idx, out=out)
    return out


class SlotStore:
    """Rotating device-resident buffer for one MoE layer's routed experts."""

    def __init__(
        self,
        num_slots: int,
        weight_shapes: Dict[str, Tuple[int, ...]],   # e.g. w_gate: (D, F)
        dtype: torch.dtype,
        device,
    ):
        self.num_slots = num_slots
        self.dtype = dtype
        self.device = torch.device(device)
        self.buffers: Params = {
            name: torch.zeros((num_slots + 1,) + tuple(shape), dtype=dtype, device=self.device)
            for name, shape in weight_shapes.items()
        }

    def write_batch(
        self,
        slots: Sequence[int],
        stacked_weights: Dict[str, torch.Tensor],   # name -> [N, ...] host rows
    ) -> int:
        """Upload N experts into ``slots``: one non-blocking host->device copy
        and one ``index_copy_`` per weight tensor. Returns bytes moved."""
        if not len(slots):
            return 0
        for slot in slots:
            if not 0 <= slot < self.num_slots:
                raise ValueError(f"slot {slot} out of range [0, {self.num_slots})")
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(self.device, non_blocking=True)
        moved = 0
        for name, w in stacked_weights.items():
            buf = self.buffers[name]
            src = w.to(device=self.device, dtype=self.dtype, non_blocking=True)
            buf.index_copy_(0, idx, src)
            moved += int(src.numel()) * src.element_size()
        return moved

    def as_dict(self) -> Params:
        """The {w_*} buffers the MoE half reads (slot ``num_slots`` = zeros)."""
        return dict(self.buffers)
