"""Slot-LUT grouped matmul on the card (``csrc/moe_gmm.cu``).

Replaces the bf16/f32 body of ``repro/kernels/moe_gmm.py:slot_gmm`` (Pallas
``_gmm_kernel``): ``out[g] = x[g] @ w[lut[g]]`` with f32 accumulation, where
``lut`` names the slot of the store each group reads. The int8/int4 bodies
are not ported yet. Bound: bytes at decode (C = 1, every weight element read
once), operations at large C. Plain version: ``kernels.ref.slot_gmm_ref``.

Two bodies, each with its own launch count: ``KERNEL`` (GEMV, C <= 4: the
decode step and the replay) and ``TILED`` (64x64 tiles: the prefill walk's
grouping of a prompt's picks by slot).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
KERNEL = CudaKernel("slot_gmm", "moe_gmm.cu", _ARGS)
TILED = CudaKernel("slot_gmm_tiled", "moe_gmm.cu", _ARGS)
GEMV_MAX_C = 4                      # GV_MAXC in csrc/moe_gmm.cu
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def slot_gmm(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """x [G, C, D], w [S+1, D, F] (same type, bf16 or f32), lut [G] int32
    slots in [0, S] -> out [G, C, F] in x's type. The LUT is not range-checked
    on the device (that would cost a sync): its owner keeps it in range."""
    if x.device.type != "cuda":
        raise ValueError(f"slot_gmm launches on CUDA tensors, got {x.device}")
    if w.device != x.device or lut.device != x.device:
        raise ValueError("x, w and lut must share one device")
    if x.dtype not in _SUFFIX or w.dtype != x.dtype:
        raise ValueError(f"slot_gmm takes bf16 or f32 x and w of one type, got {x.dtype}, {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or lut.shape != (x.shape[0],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, lut {tuple(lut.shape)}")
    g, c, d = x.shape
    if w.shape[1] != d:
        raise ValueError(f"x depth {d} != w depth {w.shape[1]}")
    f = w.shape[2]
    x = x.contiguous()
    w = w.contiguous()
    lut = lut.to(torch.int32).contiguous()
    out = torch.empty((g, c, f), dtype=x.dtype, device=x.device)
    if g and c and f:
        kernel, body = (KERNEL, "gemv") if c <= GEMV_MAX_C else (TILED, "tiled")
        kernel(f"slot_gmm_{body}_{_SUFFIX[x.dtype]}", x.device, x.data_ptr(), w.data_ptr(),
               lut.data_ptr(), g, c, d, f, out.data_ptr())
    return out
