"""Grouped int4 pack / unpack / dequant (the Q4_K_M-style slot format).

The counterpart of ``repro/quant/int4.py`` on torch tensors of any device;
packed bytes, scales and mins are byte-equal to the reference's on the same
input. Weights quantize along axis ``-2`` (the reduction dim of every expert
matrix) in groups of ``group`` rows per output column, as an asymmetric
affine code ``w ~= scale * q + mn`` with ``q`` in [0, 15] and ``scale`` /
``mn`` in f16. The quantizer works against the f16-ROUNDED scale and min, so
a dequantization reproduces what the quantizer optimized. Byte ``i`` of the
packed axis holds row ``2i`` in its low nibble and row ``2i+1`` in its high
nibble: ``[.., D/2, F]`` uint8 beside ``[.., D/G, F]`` f16 scales and mins.
Groups never span the leading expert axis, so quantizing a stack of experts
gives each expert's bytes exactly as quantizing it alone would.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

GROUP_SIZE_DEFAULT = 64

# keeps a flat group (mx == mn) from dividing by zero; f16-representable
_SCALE_EPS = 1e-6


def effective_group(rows: int, group_size: int) -> int:
    """Largest even divisor of ``rows`` that is <= ``group_size`` (real dims
    keep the requested group; small reduced dims clamp so groups tile)."""
    if rows % 2:
        raise ValueError(f"int4 packing needs an even row count, got {rows}")
    if group_size < 2:
        raise ValueError(f"group_size must be >= 2, got {group_size}")
    g = min(group_size, rows)
    while rows % g or g % 2:
        g -= 1
    return g


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, as numpy divides. On a CUDA tensor PyTorch turns a
    division by a Python scalar into a product with its reciprocal, which
    can differ in the last bit; a divisor tensor on a's device does not."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def quantize_int4(
    w: torch.Tensor, group_size: int = GROUP_SIZE_DEFAULT
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w [.., D, F] float -> (packed u8 [.., D/2, F], scale f16 [.., D/G, F],
    mn f16 [.., D/G, F]) with G = ``effective_group(D, group_size)``. The
    arithmetic is f32 and rounds half to even, as the reference's numpy."""
    w = w.float()
    d, f = w.shape[-2], w.shape[-1]
    g = effective_group(d, group_size)
    lead = tuple(w.shape[:-2])
    grp = w.reshape(lead + (d // g, g, f))
    mn = grp.amin(dim=-2).to(torch.float16)
    mx = grp.amax(dim=-2)
    scale = (true_div(mx - mn.float(), 15.0) + _SCALE_EPS).to(torch.float16)
    q = torch.round((grp - mn.float().unsqueeze(-2)) / scale.float().unsqueeze(-2))
    q = q.clamp_(0, 15).to(torch.uint8).reshape(lead + (d, f))
    packed = q[..., 0::2, :] | (q[..., 1::2, :] << 4)
    return packed, scale, mn


def quantize_int4_batch(
    w: torch.Tensor, group_size: int = GROUP_SIZE_DEFAULT
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``quantize_int4`` over a leading expert axis, w [N, .., D, F]; each
    expert's bytes equal quantizing it alone."""
    if w.dim() < 3:
        raise ValueError("batched quantization expects a leading expert axis")
    return quantize_int4(w, group_size)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed u8 [.., P, F] -> q u8 [.., 2P, F] (row 2i = low nibble of byte
    i, row 2i+1 = high nibble)."""
    q = torch.stack([packed & 0xF, packed >> 4], dim=-2)          # [.., P, 2, F]
    return q.reshape(packed.shape[:-2] + (2 * packed.shape[-2], packed.shape[-1]))


def dequantize_int4(
    packed: torch.Tensor,
    scale: torch.Tensor,
    mn: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Unpack + affine dequant, ``q * s + m`` in f32 (two roundings, no fused
    multiply-add). The group size is inferred from the shapes."""
    q = unpack_int4(packed).float()
    groups = scale.shape[-2]
    w = q.unflatten(-2, (groups, q.shape[-2] // groups))         # [.., D/G, G, F]
    w.mul_(scale.float().unsqueeze(-2)).add_(mn.float().unsqueeze(-2))
    return w.flatten(-3, -2).to(dtype)


def int4_tensor_bytes(shape: Tuple[int, ...], group_size: int = GROUP_SIZE_DEFAULT) -> int:
    """Exact packed + scales + mins bytes of one [.., D, F] tensor."""
    d, f = shape[-2], shape[-1]
    lead = math.prod(shape[:-2])
    g = effective_group(d, group_size)
    return lead * ((d // 2) * f + 2 * (d // g) * f * 2)      # u8 + f16 scale + f16 mn


def bytes_per_element(
    quantization: Optional[str],
    dtype_bytes: int = 2,
    group_size: int = GROUP_SIZE_DEFAULT,
) -> float:
    """Approximate link bytes per weight element under ``quantization``
    (int8's f32 per-channel scale counted as amortized out)."""
    if quantization == "int8":
        return 1.0
    if quantization == "int4":
        return 0.5 + 4.0 / group_size
    return float(dtype_bytes)
