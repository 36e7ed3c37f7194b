"""Flash attention for prefill on the card (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (Pallas
``_flash_kernel``): causal attention with optional sliding window and tanh
soft-cap, GQA (q head h reads KV head h // g), online softmax, unreachable
KV tiles skipped. bf16 runs on tensor cores (``mma.sync`` with bf16
operands and f32 sums, P rounded to bf16 before P V; a 64-row query tile
per block, K/V tiles through a 2-stage ``cp.async`` ring, one kernel per
head_dim, every multiple of 16 up to 256; past 128 the Q fragments are
read from shared memory per tile instead of held in registers, which the
wider O accumulators need); f32 keeps a CUDA-core body. Bound: bytes at the main path's
prefill shape, operations at longer prompts. Plain version:
``kernels.ref.flash_attention_ref``.

The chunk-append entry (:func:`flash_attention_chunk`, its own launch
count ``CHUNK``) serves chunked prefill: C queries at absolute positions
``cur_len ..`` against the engine's KV cache after the chunk's write, with
``cur_len`` read on the device, so one captured CUDA graph per chunk length
serves every chunk start. Plain version: ``kernels.ref.flash_attention_chunk_ref``.

The partial chunk entry (:func:`flash_attention_chunk_partial`, counted
under ``CHUNK`` with symbols ``flash_attention_chunk_partial_*``) scores
one slice of a cache split by sequence over the tensor axis: the chunk's C
queries at ``cur_len ..`` (read on the device) against the slice's keys at
positions ``offset ..``, causal, and gives f32 rows [B, C, H, dh + 1], each
head's normalized context and then its log-sum-exp (``-inf`` where no key of
the slice is visible), which the caller all-gathers and merges
(``distributed/parallel.py:merge_partials``): K2's partial entry for C
queries. bf16 runs the chunk entry's tensor-core body with the slice's key
offset and a partial epilogue (f32 context, natural lse); f32 a CUDA-core
body. Plain version: ``kernels.ref.flash_attention_chunk_partial_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_float],
)
_CHUNK_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                              ctypes.c_float]
# q, k, v, out, cur_len, B, C, S_loc, H, Hkv, dh, offset, scale, soft_cap
_PARTIAL_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
CHUNK = CudaKernel("flash_attention_chunk", "flash_attention.cu", {
    "flash_attention_chunk_bf16": _CHUNK_ARGS, "flash_attention_chunk_f32": _CHUNK_ARGS,
    "flash_attention_chunk_partial_bf16": _PARTIAL_ARGS,
    "flash_attention_chunk_partial_f32": _PARTIAL_ARGS,
})
_SYMBOL = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
MAX_HEAD_DIM = 256          # csrc/flash_attention.cu: FA_MAXDH and the bf16 instances
_CHUNK_SYMBOL = {torch.bfloat16: "flash_attention_chunk_bf16",
                 torch.float32: "flash_attention_chunk_f32"}
PARTIAL_SYMBOLS = {torch.bfloat16: "flash_attention_chunk_partial_bf16",
                   torch.float32: "flash_attention_chunk_partial_f32"}


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int]) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {q.device}")
    if q.dtype not in _SYMBOL or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"bf16 or f32 q/k/v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, h, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, Skv, Hkv, dh], got {tuple(k.shape)}, {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"H={h} must be a multiple of Hkv={k.shape[2]}")
    if dh % 16 or not 16 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} must be a multiple of 16 and at most {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")


def _check_cur_len(q: torch.Tensor, cur_len: torch.Tensor) -> None:
    if (cur_len.device != q.device or cur_len.dtype != torch.int64
            or cur_len.numel() != 1):
        raise ValueError(f"cur_len must be one int64 on {q.device}, got {cur_len.dtype} "
                         f"{tuple(cur_len.shape)} on {cur_len.device}")


def _aligned(*ts: torch.Tensor):
    """The bf16 body copies 16-byte rows: a view that starts off that grid is copied."""
    return tuple(t.contiguous() if t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format) for t in ts)


def flash_attention(
    q: torch.Tensor,            # [B, Sq, H, dh]
    k: torch.Tensor,            # [B, Skv, Hkv, dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    _check_qkv("flash_attention", q, k, v, window)
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    if b and sq:
        KERNEL(_SYMBOL[q.dtype], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, sq, skv, h, hkv, dh, 1.0 / math.sqrt(dh), int(causal),
               int(window) if window is not None else 0,
               float(soft_cap) if soft_cap is not None else 0.0)
    return out


def flash_attention_chunk(
    q: torch.Tensor,            # [B, C, H, dh] at positions cur_len .. cur_len + C - 1
    k: torch.Tensor,            # [B, cap, Hkv, dh] the cache after the chunk's write
    v: torch.Tensor,
    cur_len: torch.Tensor,      # int64 scalar on q's device
    *,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of a chunk's queries against the cache: query i
    (absolute position ``cur_len + i``) scores slots ``0 .. cur_len + i``
    (inside the window). The cache must not wrap: ``cur_len + C <= cap``,
    which the caller checks on the host, since ``cur_len`` stays on the
    device (a CUDA graph replays the launch with the host setting it)."""
    _check_qkv("flash_attention_chunk", q, k, v, window)
    _check_cur_len(q, cur_len)
    b, c, h, dh = q.shape
    cap, hkv = k.shape[1], k.shape[2]
    if c > cap:
        raise ValueError(f"a chunk of {c} queries exceeds the cache capacity {cap}")
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    if b and c:
        CHUNK(_CHUNK_SYMBOL[q.dtype], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              out.data_ptr(), cur_len.data_ptr(), b, c, cap, h, hkv, dh, 1.0 / math.sqrt(dh),
              int(window) if window is not None else 0,
              float(soft_cap) if soft_cap is not None else 0.0)
    return out


def flash_attention_chunk_partial(
    q: torch.Tensor,            # [B, C, H, dh] at positions cur_len .. cur_len + C - 1
    k: torch.Tensor,            # [B, S_loc, Hkv, dh] a slice: positions offset .. offset + S_loc - 1
    v: torch.Tensor,
    cur_len: torch.Tensor,      # int64 scalar on q's device
    offset: int,
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """The partial chunk entry: f32 [B, C, H, dh + 1], each head's context
    over the slice's keys at positions ``<= cur_len + i`` (normalized), then
    its log-sum-exp; ``-inf`` and a zero context where none is visible."""
    _check_qkv("flash_attention_chunk_partial", q, k, v, None)
    _check_cur_len(q, cur_len)
    if offset < 0:
        raise ValueError(f"a slice's offset must be >= 0, got {offset}")
    b, c, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    q, k, v = _aligned(q, k, v)
    out = torch.empty((b, c, h, dh + 1), dtype=torch.float32, device=q.device)
    if b and c:
        CHUNK(PARTIAL_SYMBOLS[q.dtype], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              out.data_ptr(), cur_len.data_ptr(), b, c, s, h, hkv, dh, int(offset),
              1.0 / math.sqrt(dh), float(soft_cap) if soft_cap is not None else 0.0)
    return out
