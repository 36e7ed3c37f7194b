"""Flash attention for prefill on the card (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (Pallas
``_flash_kernel``): causal attention with optional sliding window and tanh
soft-cap, GQA (q head h reads KV head h // g), online softmax, unreachable
KV tiles skipped. One block per 64-row query tile of one head. Bound:
operations. Plain version: ``kernels.ref.flash_attention_ref``.
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
_SYMBOL = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}


def flash_attention(
    q: torch.Tensor,            # [B, Sq, H, dh]
    k: torch.Tensor,            # [B, Skv, Hkv, dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors, got {q.device}")
    if q.dtype not in _SYMBOL or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"bf16 or f32 q/k/v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, Skv, Hkv, dh], got {tuple(k.shape)}, {tuple(v.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if dh % 16 or dh > 128:
        raise ValueError(f"head_dim {dh} must be a multiple of 16 and at most 128")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if b and sq:
        KERNEL(_SYMBOL[q.dtype], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, sq, skv, h, hkv, dh, 1.0 / math.sqrt(dh), int(causal),
               int(window) if window is not None else 0,
               float(soft_cap) if soft_cap is not None else 0.0)
    return out
