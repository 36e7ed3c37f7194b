"""Flash-decode on the card (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py:decode_attention`` (Pallas
``_decode_kernel``): one query token per row against the contiguous cache,
the g query heads of a KV head scored together, per-row valid lengths,
optional tanh soft-cap, online softmax. One launch and no workspace: the KV
axis is cut into spans, one block each, and the spans of one (row, KV head)
form a thread block cluster that merges its partials in span order through
distributed shared memory. bf16 at every dh that is a multiple of 16 up to
256 runs on tensor cores, the rest on CUDA cores. The plan
(:func:`decode_plan`) reads S, dh, g and the type only, so a row gives the
same bits whatever the batch and the other rows' lengths. Bound: bytes (each valid K/V element read once). Plain
version: ``kernels.ref.decode_attention_ref``.

The paged entry (:func:`decode_attention_paged`) scores the serving
engine's KV pool: shared planes [P, ps, Hkv, dh] read through each row's
page table by the kernel itself (no gathered copy), with the contiguous
entry's plan at S = pages * ps, so it gives the contiguous entry's bits on
the gathered view. Plain version: ``kernels.ref.decode_attention_paged_ref``.

The partial entry (:func:`decode_attention_partial`) scores one slice of a
cache split by sequence over ranks: the contiguous entry's plan and body at
the slice's length, per-row local lengths that may be 0, and f32 rows [B, H,
dh + 1] out, each head's normalized context followed by its log-sum-exp
(``-inf`` for an empty slice), which the caller all-gathers and merges
(``distributed/parallel.py:merge_partials``). Plain version:
``kernels.ref.decode_attention_partial_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel

MAX_GROUP = 16      # query heads per KV head; csrc/decode_attention.cu:DA_MAXG
MAX_SPLITS = 16     # spans of one cluster; DA_MAXSPLITS (non-portable above 8)
TILES = (32, 64)    # positions per tile the kernel takes
TENSOR_CORE_DH = tuple(range(16, 257, 16))     # csrc/decode_attention.cu:DA_TC_CASE

_CONTIGUOUS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# q, k, v, lengths, page_table, B, H, Hkv, npages, ps, dh, scale, soft_cap,
# splits, tile, span, tensor_cores, vec, out
_PAGED = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
          + [ctypes.c_int] * 5 + [ctypes.c_void_p])
KERNEL = CudaKernel("decode_attention", "decode_attention.cu", {
    "decode_attention_bf16": _CONTIGUOUS, "decode_attention_f32": _CONTIGUOUS,
    "decode_attention_paged_bf16": _PAGED, "decode_attention_paged_f32": _PAGED,
    "decode_attention_partial_bf16": _CONTIGUOUS, "decode_attention_partial_f32": _CONTIGUOUS,
})
_SYMBOL = {torch.bfloat16: "decode_attention_bf16", torch.float32: "decode_attention_f32"}
PAGED_SYMBOLS = {torch.bfloat16: "decode_attention_paged_bf16",
                 torch.float32: "decode_attention_paged_f32"}
PARTIAL_SYMBOLS = {torch.bfloat16: "decode_attention_partial_bf16",
                   torch.float32: "decode_attention_partial_f32"}


@dataclass(frozen=True)
class DecodePlan:
    """How one (row, KV head) cuts the cache: ``splits`` blocks (one
    cluster) of ``span`` positions each, scored ``tile`` positions at a time;
    ``tensor_cores``: the bf16 mma body (else CUDA cores)."""

    splits: int
    tile: int
    span: int
    tensor_cores: bool


@functools.lru_cache(maxsize=None)
def decode_plan(s: int, dh: int, g: int, dtype: torch.dtype) -> DecodePlan:
    """The plan for a cache of ``s`` positions, head dim ``dh``, ``g`` query
    heads per KV head and element type ``dtype``. It reads neither B nor a
    row's length: a row's sum runs in the same order in every batch. Spans of
    one tile each up to the split cap, longer spans past that. CUDA cores:
    tiles of 32, up to 16 splits. Tensor cores: at g > 4 (few KV heads a
    row: 4 for 32 query heads at g 8) tiles of 64 and up to 16 splits, so
    one row's few (row, KV head) pairs still fill the card; at g <= 4 (8 or
    more KV heads) at most max(4, 2 g) splits, since there the pairs alone
    make hundreds of blocks and each extra split costs a block's fixed cost
    (Q staged, a cluster merge) for one tile's work, in tiles of 32, or one
    tile of 64 where the spans are no longer (``tools/torch_kernel_sweep.py
    --only widths``: over 4 rows of 1024 positions, 4 spans of 256 at dh 96
    g 1 and 8 of 128 at dh 160 g 4 take 41% and 58% of the time of 16 spans
    of 64; over tp-qwen3-4b's 2 rows of 512, 8 spans of one 64-position tile
    beat 8 of two 32-position tiles)."""
    tensor_cores = dtype == torch.bfloat16 and dh in TENSOR_CORE_DH
    wide = tensor_cores and g > 4
    cap = MAX_SPLITS if wide or not tensor_cores else max(4, 2 * g)
    tile = 64 if wide or (tensor_cores and _cdiv(s, cap) <= 64) else 32
    splits = min(cap, _cdiv(s, tile))
    span = _cdiv(_cdiv(s, splits), tile) * tile
    return DecodePlan(splits=_cdiv(s, span), tile=tile, span=span, tensor_cores=tensor_cores)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention launches on CUDA tensors, got {q.device}")
    if q.dtype not in _SYMBOL or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"bf16 or f32 q/k/v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")


def decode_attention(
    q: torch.Tensor,            # [B, H, dh]
    k: torch.Tensor,            # [B, S, Hkv, dh]
    v: torch.Tensor,
    lengths: torch.Tensor,      # [B] int: valid positions per row, >= 1
    *,
    soft_cap: Optional[float] = None,
    partial: bool = False,
) -> torch.Tensor:
    """K2's contiguous entry: [B, H, dh] in q's type. ``partial``: the
    partial entry (lengths may be 0), f32 [B, H, dh + 1], each head's
    normalized context and then its log-sum-exp."""
    _check_q(q, k, v)
    b, h, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"cache k/v must be [B, S, Hkv, dh], got {tuple(k.shape)}, {tuple(v.shape)}")
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with at most {MAX_GROUP} per group")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    plan = decode_plan(s, dh, h // hkv, q.dtype)
    vec = (dh * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v))
    if partial:
        out = torch.empty((b, h, dh + 1), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty_like(q)
    KERNEL((PARTIAL_SYMBOLS if partial else _SYMBOL)[q.dtype], q.device, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), lengths.data_ptr(), b, h, hkv, s, dh, 1.0 / math.sqrt(dh),
           float(soft_cap) if soft_cap is not None else 0.0,
           plan.splits, plan.tile, plan.span, int(plan.tensor_cores and vec), int(vec),
           out.data_ptr())
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor, *,
                             soft_cap: Optional[float] = None) -> torch.Tensor:
    """K2's partial entry over one slice k/v [B, S_loc, Hkv, dh] at local
    ``lengths`` [B] (0 .. S_loc): f32 [B, H, dh + 1], context then lse."""
    return decode_attention(q, k, v, lengths, soft_cap=soft_cap, partial=True)


def decode_attention_paged(
    q: torch.Tensor,            # [B, H, dh]
    k: torch.Tensor,            # [P, ps, Hkv, dh] shared planes
    v: torch.Tensor,
    page_table: torch.Tensor,   # [B, n_pages] int32 plane pages of each row
    lengths: torch.Tensor,      # [B] int: valid positions per row, >= 1
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """K2's paged entry: row b's logical position s is plane row
    ``page_table[b, s // ps] * ps + s % ps``; scores ``lengths[b]``
    positions of the row's logical cache of ``n_pages * ps``."""
    _check_q(q, k, v)
    b, h, dh = q.shape
    if k.dim() != 4 or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"planes k/v must be [P, ps, Hkv, dh], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b or page_table.device != q.device:
        raise ValueError(f"page_table must be [B, pages] on {q.device}, got "
                         f"{tuple(page_table.shape)} on {page_table.device}")
    ps, hkv = k.shape[1], k.shape[2]
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with at most {MAX_GROUP} "
                         f"per group")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    n_pages = page_table.shape[1]
    plan = decode_plan(n_pages * ps, dh, h // hkv, q.dtype)
    vec = (dh * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v))
    out = torch.empty_like(q)
    KERNEL(PAGED_SYMBOLS[q.dtype], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           lengths.data_ptr(), page_table.data_ptr(), b, h, hkv, n_pages, ps, dh,
           1.0 / math.sqrt(dh), float(soft_cap) if soft_cap is not None else 0.0,
           plan.splits, plan.tile, plan.span, int(plan.tensor_cores and vec), int(vec),
           out.data_ptr())
    return out
