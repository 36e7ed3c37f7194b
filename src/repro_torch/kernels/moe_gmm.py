"""Slot-LUT grouped matmul on the card (``csrc/moe_gmm.cu``).

Replaces ``repro/kernels/moe_gmm.py:slot_gmm`` with all three of its Pallas
bodies: ``out[g] = x[g] @ w[lut[g]]`` with f32 accumulation, where ``lut``
names the slot of the store each group reads. bf16/f32 slots (``_gmm_kernel``)
give x's type; int8 slots (``_gmm_kernel_int8``: the per-channel scale on
the accumulator) and int4 slots (``_gmm_kernel_int4``: nibbles dequantized
``q * s + m`` before the product) give f32, read as packed bytes straight
from the store. Bound: bytes at decode (C = 1, every weight byte read once),
operations at large C. Plain version: ``kernels.ref.slot_gmm_ref``.

Two bodies per format, each with its own launch count (``launch_counts``;
``symbol_launch_counts`` splits the tiled body's by entry):

* the GEMV body for C <= 4 (the decode step and the replay) streams the
  weights in 16-byte loads per lane (8 bytes for int8 and int4), with the
  stored rows cut into up to 8 splits across the blocks of a thread block
  cluster, which sum the splits in split order through distributed shared
  memory. Its plan (:func:`gemv_plan`: rows per warp, splits, vector or
  element loads) is made here alone, from D, F and the format, never C or
  G, so the output is the same bits on every launch and row c does not
  depend on C; the kernel only checks it. Rows whose width is not a
  multiple of a lane's bytes (or a store not 16-byte aligned) take the
  same kernel's element loads: a dispatch by shape, never a retry;
* the tiled body for C > 4. With bf16 x it runs on tensor cores
  (``mma.sync`` m16n8k16, f32 sums, a 3-stage ``cp.async`` ring; int8 and
  int4 weights converted to exact bf16 integers in shared memory, int4's
  group affine folded in per group as ``s * (x . q) + m * sum(x)``); f32 x,
  and rows that are not whole 16-byte copies or int4 groups other than 32,
  64 and 128, take the CUDA-core body. Its plan (:func:`tiled_plan`: tensor cores or not, the D
  step, the N tile) reads neither C nor G: the sum over D runs in one order
  whatever the batch, and row c does not depend on C.

The tiled body's ragged entry (:func:`slot_gmm_ragged`, counted with the
tiled body under its own launcher symbols ``*_ragged_*``) takes the picks'
rows sorted by slot with each slot's first row in a device tensor of
offsets, so a prefill's MoE half (a chunk's, or the legacy walk's whole
prompt) makes no host round trip and a CUDA graph can capture it; the same
plan as the grouped entry, so a row gives the same bits either way. Plain
version: ``kernels.ref.slot_gmm_ragged_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int


def _argtypes(planes: int):
    """x, w, the store's ``planes`` (int8: scale; int4: scale, mn), lut, G, C,
    D, F, [group (int4),] then rows_per_warp, splits, vector (GEMV) or
    tensor_cores, block_k, block_n (tiled), then out."""
    return [_P] * (3 + planes) + [_I] * (7 + (planes == 2)) + [_P]


def _ragged_argtypes(planes: int):
    """The ragged entry: x, w, the store's ``planes``, offsets, N, S1, miss,
    D, F, [group (int4),] tensor_cores, block_k, block_n, then out."""
    return [_P] * (3 + planes) + [_I] * (8 + (planes == 2)) + [_P]


def _tiled_argtypes(planes: int, stem: str):
    """The tiled body's two entries, one count: the grouped launchers
    ``{stem}_tiled_*`` and the ragged ones ``{stem}_ragged_*``."""
    return {f"{stem}_{entry}_{sfx}": types for sfx in ("bf16", "f32")
            for entry, types in (("tiled", _argtypes(planes)),
                                 ("ragged", _ragged_argtypes(planes)))}


KERNEL = CudaKernel("slot_gmm", "moe_gmm.cu", _argtypes(0))
TILED = CudaKernel("slot_gmm_tiled", "moe_gmm.cu", _tiled_argtypes(0, "slot_gmm"))
INT8 = CudaKernel("slot_gmm_int8", "moe_gmm.cu", _argtypes(1))
INT8_TILED = CudaKernel("slot_gmm_int8_tiled", "moe_gmm.cu", _tiled_argtypes(1, "slot_gmm_int8"))
INT4 = CudaKernel("slot_gmm_int4", "moe_gmm.cu", _argtypes(2))
INT4_TILED = CudaKernel("slot_gmm_int4_tiled", "moe_gmm.cu", _tiled_argtypes(2, "slot_gmm_int4"))
GEMV_MAX_C = 4                      # GV_MAXC in csrc/moe_gmm.cu
GEMV_WARPS = 8                      # GV_WARPS: runs of rows per block
GEMV_MAX_SPLITS = 8                 # GV_MAXSPLITS: the blocks of one (portable) cluster
GEMV_RUN = 32                       # rows a warp's run aims at (16 for int4, which
GEMV_RUN_INT4 = 16                  # costs twice the ALU work per weight)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_BODIES = {                         # weight type -> (GEMV kernel, tiled kernel, symbol stem)
    torch.bfloat16: (KERNEL, TILED, "slot_gmm"),
    torch.float32: (KERNEL, TILED, "slot_gmm"),
    torch.int8: (INT8, INT8_TILED, "slot_gmm_int8"),
    torch.uint8: (INT4, INT4_TILED, "slot_gmm_int4"),
}


@dataclass(frozen=True)
class GemvPlan:
    """How the GEMV body cuts one group's work: a block's 8 warps take
    ``rows_per_warp`` stored rows each (D, or D/2 packed int4 rows, in all),
    ``splits`` blocks (one cluster) cover them. ``vector``: rows are whole
    lane loads (16 bytes; 8 for int8 and int4), so lanes load whole chunks
    (else element loads)."""

    rows_per_warp: int
    splits: int
    vector: bool


@functools.lru_cache(maxsize=None)
def gemv_plan(d: int, f: int, w_dtype: torch.dtype) -> GemvPlan:
    """The GEMV body's plan for depth ``d``, width ``f`` and a store of
    ``w_dtype`` (uint8: packed int4). It reads neither C nor G, so the sum
    over D is taken in one order whatever the batch. A warp's run is
    ``GEMV_RUN`` rows (``GEMV_RUN_INT4`` for int4), longer where 8 splits
    (one cluster) would not cover D; the splits follow from the run."""
    quant = w_dtype in (torch.int8, torch.uint8)
    elem = 1 if quant else torch.finfo(w_dtype).bits // 8
    rows = d // 2 if w_dtype == torch.uint8 else d
    run = GEMV_RUN_INT4 if w_dtype == torch.uint8 else GEMV_RUN
    rw = max(run, _cdiv(rows, GEMV_WARPS * GEMV_MAX_SPLITS))
    return GemvPlan(rows_per_warp=rw, splits=_cdiv(rows, GEMV_WARPS * rw),
                    vector=(f * elem) % (8 if quant else 16) == 0)


@dataclass(frozen=True)
class TiledPlan:
    """How the tiled body cuts one group's work: 64 rows of x by
    ``block_n`` columns per block, D in steps of ``block_k``, on tensor cores
    (``tensor_cores``) or on CUDA cores (64 x 64 tiles, D in steps of 32)."""

    tensor_cores: bool
    block_k: int = 0
    block_n: int = 0


# (D step, N tile) per store format, from tools/torch_kernel_sweep.py at the
# prefill shape (csrc/moe_gmm.cu tiled::launch_tile takes 32 or 64 by 64 or
# 128): int4's second accumulator makes 128 columns a warp too many registers
# for two blocks per SM
TILED_TILE = {torch.bfloat16: (32, 128), torch.int8: (64, 128), torch.uint8: (64, 64)}
TILED_INT4_GROUPS = (32, 64, 128)   # int4 groups of the tensor-core body (a template parameter)


@functools.lru_cache(maxsize=None)
def tiled_plan(d: int, f: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
               group: int = 0) -> TiledPlan:
    """The tiled body's plan for depth ``d``, width ``f``, x of ``x_dtype``,
    a store of ``w_dtype`` (uint8: packed int4 with groups of ``group``). It
    reads neither C nor G. Tensor cores take bf16 x with whole 16-byte
    copies of x's rows (D % 8) and of the stored rows (F % 8 for bf16, F % 16
    for int8 and int4), and int4 groups of 32, 64 or 128 (``s * (x . q)``
    per group needs the group in whole k16 slices of whole steps or whole
    runs of steps; the kernel knows the group at compile time)."""
    if x_dtype != torch.bfloat16 or w_dtype not in TILED_TILE or d % 8:
        return TiledPlan(False)
    per_copy = 8 if w_dtype == torch.bfloat16 else 16      # stored elements in 16 bytes
    if f % per_copy or (w_dtype == torch.uint8 and group not in TILED_INT4_GROUPS):
        return TiledPlan(False)
    return TiledPlan(True, *TILED_TILE[w_dtype])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_plane(name: str, t: Optional[torch.Tensor], shape, dtype, device) -> torch.Tensor:
    if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        got = None if t is None else (t.dtype, tuple(t.shape), str(t.device))
        raise ValueError(f"slot_gmm: {name} must be {dtype} {tuple(shape)} on {device}, got {got}")
    return t.contiguous()


def _store(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
           mn: Optional[torch.Tensor]):
    """Check a store against x's depth and type: ``(planes, group, out
    dtype)``, the planes (int8: scale; int4: scale, mn) contiguous and the
    int4 group (0 for the other formats)."""
    d = x.shape[-1]
    s1, f = w.shape[0], w.shape[2]
    depth = 2 * w.shape[1] if w.dtype == torch.uint8 else w.shape[1]
    if depth != d:
        raise ValueError(f"x depth {d} != w depth {depth}")
    if w.dtype in (torch.bfloat16, torch.float32):
        if w.dtype != x.dtype or scale is not None or mn is not None:
            raise ValueError(f"a {w.dtype} store takes x of its type and no scale/min planes")
        return [], 0, x.dtype
    if w.dtype == torch.int8:
        if mn is not None:
            raise ValueError("an int8 store takes no min plane")
        return [_check_plane("scale", scale, (s1, f), torch.float32, x.device)], 0, torch.float32
    if scale is None or scale.dim() != 3 or d % scale.shape[1] or (d // scale.shape[1]) % 2:
        raise ValueError(f"an int4 store takes f16 scale/min planes [S+1, D/G, F] with "
                         f"an even G dividing D={d}")
    group = d // scale.shape[1]
    planes = [_check_plane(n, t, (s1, d // group, f), torch.float16, x.device)
              for n, t in (("scale", scale), ("mn", mn))]
    return planes, group, torch.float32


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
    f = w.shape[2]
    planes, group, out_dtype = _store(x, w, scale, mn)
    x = x.contiguous()
    w = w.contiguous()
    lut = lut.to(torch.int32).contiguous()
    out = torch.empty((g, c, f), dtype=out_dtype, device=x.device)
    if g and c and f:
        gemv, tiled, stem = _BODIES[w.dtype]
        ptrs = [p.data_ptr() for p in planes]
        lead = (x.data_ptr(), w.data_ptr(), *ptrs, lut.data_ptr(), g, c, d, f)
        lead += (group,) if group else ()
        symbol = _SUFFIX[x.dtype]
        if c <= GEMV_MAX_C:
            plan = gemv_plan(d, f, w.dtype)
            aligned = all(p % 16 == 0 for p in (w.data_ptr(), *ptrs))
            gemv(f"{stem}_gemv_{symbol}", x.device, *lead, plan.rows_per_warp, plan.splits,
                 int(plan.vector and aligned), out.data_ptr())
        else:
            plan = tiled_plan(d, f, x.dtype, w.dtype, group)
            aligned = all(p % 16 == 0 for p in (x.data_ptr(), w.data_ptr(), *ptrs))
            tc = plan.tensor_cores and aligned
            tiled(f"{stem}_tiled_{symbol}", x.device, *lead, int(tc),
                  plan.block_k if tc else 0, plan.block_n if tc else 0, out.data_ptr())
    return out


def slot_gmm_ragged(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    mn: Optional[torch.Tensor] = None, *,
                    miss_slot: Optional[int] = None) -> torch.Tensor:
    """x [N, D] (bf16 or f32) holding rows sorted by slot, ``offsets``
    [S1+1] int32 on the device: rows ``offsets[s] .. offsets[s+1]`` read
    slot s of the store w [S1, ...] (the formats of :func:`slot_gmm`); the
    rows of ``miss_slot`` (the MISS row) come out as zeros, its weights
    unread. Returns [N, F]. The tiled body's plan; no count leaves the
    device (the offsets are not checked there either: their owner makes them
    from a sort)."""
    if x.device.type != "cuda":
        raise ValueError(f"slot_gmm_ragged launches on CUDA tensors, got {x.device}")
    if w.device != x.device or offsets.device != x.device:
        raise ValueError("x, w and offsets must share one device")
    if x.dtype not in _SUFFIX or w.dtype not in _BODIES:
        raise ValueError(f"slot_gmm_ragged takes bf16/f32 x and bf16/f32/int8/uint8 w, "
                         f"got {x.dtype}, {w.dtype}")
    s1 = w.shape[0]
    if x.dim() != 2 or w.dim() != 3 or offsets.shape != (s1 + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, offsets "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    n, d = x.shape
    f = w.shape[2]
    planes, group, out_dtype = _store(x, w, scale, mn)
    x = x.contiguous()
    w = w.contiguous()
    offsets = offsets.contiguous()
    out = torch.empty((n, f), dtype=out_dtype, device=x.device)
    if n and f:
        ptrs = [p.data_ptr() for p in planes]
        plan = tiled_plan(d, f, x.dtype, w.dtype, group)
        tc = plan.tensor_cores and all(p % 16 == 0 for p in (x.data_ptr(), w.data_ptr(), *ptrs))
        stem = _BODIES[w.dtype][2]
        miss = -1 if miss_slot is None else int(miss_slot)
        args = (x.data_ptr(), w.data_ptr(), *ptrs, offsets.data_ptr(), n, s1, miss, d, f)
        args += (group,) if group else ()
        _BODIES[w.dtype][1](f"{stem}_ragged_{_SUFFIX[x.dtype]}", x.device, *args, int(tc),
                            plan.block_k if tc else 0, plan.block_n if tc else 0, out.data_ptr())
    return out
