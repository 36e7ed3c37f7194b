"""Slot-LUT grouped matmul on the card (``csrc/moe_gmm.cu``).

Replaces ``repro/kernels/moe_gmm.py:slot_gmm`` with all three of its Pallas
bodies: ``out[g] = x[g] @ w[lut[g]]`` with f32 accumulation, where ``lut``
names the slot of the store each group reads. bf16/f32 slots (``_gmm_kernel``)
give x's type; int8 slots (``_gmm_kernel_int8``: the per-channel scale on
the accumulator) and int4 slots (``_gmm_kernel_int4``: nibbles dequantized
``q * s + m`` before the product) give f32, read as packed bytes straight
from the store. Bound: bytes at decode (C = 1, every weight byte read once),
operations at large C. Plain version: ``kernels.ref.slot_gmm_ref``.

Two bodies per format, each with its own launch count: the GEMV body for
C <= 4 (the decode step and the replay) and the tiled body (64x64 tiles: the
prefill walk's grouping of a prompt's picks by slot).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P]                  # x, w, lut, G, C, D, F, out
_ARGS_INT8 = [_P, _P, _P, _P, _I, _I, _I, _I, _P]         # x, w, scale, lut, ...
_ARGS_INT4 = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]  # x, w, scale, mn, lut, .., group, out
KERNEL = CudaKernel("slot_gmm", "moe_gmm.cu", _ARGS)
TILED = CudaKernel("slot_gmm_tiled", "moe_gmm.cu", _ARGS)
INT8 = CudaKernel("slot_gmm_int8", "moe_gmm.cu", _ARGS_INT8)
INT8_TILED = CudaKernel("slot_gmm_int8_tiled", "moe_gmm.cu", _ARGS_INT8)
INT4 = CudaKernel("slot_gmm_int4", "moe_gmm.cu", _ARGS_INT4)
INT4_TILED = CudaKernel("slot_gmm_int4_tiled", "moe_gmm.cu", _ARGS_INT4)
GEMV_MAX_C = 4                      # GV_MAXC in csrc/moe_gmm.cu
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_BODIES = {                         # weight type -> (GEMV kernel, tiled kernel, symbol stem)
    torch.bfloat16: (KERNEL, TILED, "slot_gmm"),
    torch.float32: (KERNEL, TILED, "slot_gmm"),
    torch.int8: (INT8, INT8_TILED, "slot_gmm_int8"),
    torch.uint8: (INT4, INT4_TILED, "slot_gmm_int4"),
}


def _check_plane(name: str, t: Optional[torch.Tensor], shape, dtype, device) -> torch.Tensor:
    if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        got = None if t is None else (t.dtype, tuple(t.shape), str(t.device))
        raise ValueError(f"slot_gmm: {name} must be {dtype} {tuple(shape)} on {device}, got {got}")
    return t.contiguous()


def slot_gmm(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
             scale: Optional[torch.Tensor] = None,
             mn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [G, C, D] (bf16 or f32), lut [G] int32 slots in [0, S], and one of:

    * w [S+1, D, F] in x's type -> out [G, C, F] in x's type;
    * w [S+1, D, F] int8, scale [S+1, F] f32 -> out f32;
    * w [S+1, D/2, F] uint8, scale and mn [S+1, D/G, F] f16 (G even) -> out f32.

    The LUT is not range-checked on the device (that would cost a sync): its
    owner keeps it in range."""
    if x.device.type != "cuda":
        raise ValueError(f"slot_gmm launches on CUDA tensors, got {x.device}")
    if w.device != x.device or lut.device != x.device:
        raise ValueError("x, w and lut must share one device")
    if x.dtype not in _SUFFIX or w.dtype not in _BODIES:
        raise ValueError(f"slot_gmm takes bf16/f32 x and bf16/f32/int8/uint8 w, "
                         f"got {x.dtype}, {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or lut.shape != (x.shape[0],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, lut {tuple(lut.shape)}")
    g, c, d = x.shape
    s1, f = w.shape[0], w.shape[2]
    depth = 2 * w.shape[1] if w.dtype == torch.uint8 else w.shape[1]
    if depth != d:
        raise ValueError(f"x depth {d} != w depth {depth}")
    planes = []
    group = 0
    if w.dtype in (torch.bfloat16, torch.float32):
        if w.dtype != x.dtype or scale is not None or mn is not None:
            raise ValueError(f"a {w.dtype} store takes x of its type and no scale/min planes")
        out_dtype = x.dtype
    elif w.dtype == torch.int8:
        if mn is not None:
            raise ValueError("an int8 store takes no min plane")
        planes = [_check_plane("scale", scale, (s1, f), torch.float32, x.device)]
        out_dtype = torch.float32
    else:
        if scale is None or scale.dim() != 3 or d % scale.shape[1] or (d // scale.shape[1]) % 2:
            raise ValueError(f"an int4 store takes f16 scale/min planes [S+1, D/G, F] with "
                             f"an even G dividing D={d}")
        group = d // scale.shape[1]
        planes = [_check_plane(n, t, (s1, d // group, f), torch.float16, x.device)
                  for n, t in (("scale", scale), ("mn", mn))]
        out_dtype = torch.float32
    x = x.contiguous()
    w = w.contiguous()
    lut = lut.to(torch.int32).contiguous()
    out = torch.empty((g, c, f), dtype=out_dtype, device=x.device)
    if g and c and f:
        gemv, tiled, stem = _BODIES[w.dtype]
        kernel, body = (gemv, "gemv") if c <= GEMV_MAX_C else (tiled, "tiled")
        ptrs = [p.data_ptr() for p in planes]
        tail = (group, out.data_ptr()) if group else (out.data_ptr(),)
        kernel(f"{stem}_{body}_{_SUFFIX[x.dtype]}", x.device, x.data_ptr(), w.data_ptr(),
               *ptrs, lut.data_ptr(), g, c, d, f, *tail)
    return out
