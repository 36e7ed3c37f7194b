"""Flash-decode on the card (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py:decode_attention`` (Pallas
``_decode_kernel``): one query token per row against the contiguous cache,
the g query heads of a KV head scored together, per-row valid lengths,
optional tanh soft-cap, online softmax. The KV axis is split across blocks
in chunks of 64 positions and the partials are merged by a second kernel.
Bound: bytes (each valid K/V element read once). Plain version:
``kernels.ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel

CHUNK = 64          # KV positions per block; csrc/decode_attention.cu:DA_CHUNK
MAX_GROUP = 16      # query heads per KV head; csrc/decode_attention.cu:DA_MAXG

KERNEL = CudaKernel(
    "decode_attention", "decode_attention.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_void_p] * 4,
)
_SYMBOL = {torch.bfloat16: "decode_attention_bf16", torch.float32: "decode_attention_f32"}


def decode_attention(
    q: torch.Tensor,            # [B, H, dh]
    k: torch.Tensor,            # [B, S, Hkv, dh]
    v: torch.Tensor,
    lengths: torch.Tensor,      # [B] int: valid positions per row, >= 1
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention launches on CUDA tensors, got {q.device}")
    if q.dtype not in _SYMBOL or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"bf16 or f32 q/k/v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"cache k/v must be [B, S, Hkv, dh], got {tuple(k.shape)}, {tuple(v.shape)}")
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with at most {MAX_GROUP} per group")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    g = h // hkv
    nsplit = (s + CHUNK - 1) // CHUNK
    dev = q.device
    m_ws = torch.empty((b * hkv, nsplit, g), dtype=torch.float32, device=dev)
    l_ws = torch.empty_like(m_ws)
    acc_ws = torch.empty((b * hkv, nsplit, g, dh), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    KERNEL(_SYMBOL[q.dtype], dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           lengths.data_ptr(), b, h, hkv, s, dh, 1.0 / math.sqrt(dh),
           float(soft_cap) if soft_cap is not None else 0.0,
           m_ws.data_ptr(), l_ws.data_ptr(), acc_ws.data_ptr(), out.data_ptr())
    return out
