"""Fused softmax + top-k router gate on the card (``csrc/topk_gate.cu``).

Replaces ``repro/kernels/topk_gate.py:topk_gate`` (Pallas ``_topk_kernel``).
One warp per row: softmax over the E logits in shared memory, then k rounds
of argmax with the lowest index winning ties, then optional renormalization.
Bound: bytes (E f32 in, 2k values out per row). Plain version:
``kernels.ref.topk_gate_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaKernel

KERNEL = CudaKernel(
    "topk_gate", "topk_gate.cu",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p],
)


def topk_gate(
    logits: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] f32 on a CUDA device -> (ids int32 [T, k], weights f32 [T, k])."""
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gate launches on a CUDA tensor, got {logits.device}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be [T, E], got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= e:
        raise ValueError(f"k={k} outside [1, E={e}]")
    logits = logits.float().contiguous()
    ids = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    w = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    if t:
        KERNEL("topk_gate_f32", logits.device, logits.data_ptr(), t, e, k,
               int(normalize), ids.data_ptr(), w.data_ptr())
    return ids, w
