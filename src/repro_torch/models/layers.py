"""Shared layer primitives: norms, RoPE, activations, init helpers.

The counterpart of ``repro/models/layers.py``: norms and RoPE compute in f32
and cast back, as there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------
def dense_init(
    gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
    device, fan_in: Optional[int] = None,
) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) init scaled by 1/sqrt(fan_in)."""
    fan = fan_in if fan_in is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(max(fan, 1))).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
               device) -> torch.Tensor:
    w = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------
def init_norm(kind: str, dim: int, dtype: torch.dtype, device) -> Params:
    p: Params = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.to(x.dtype)


def rms_norm_headdim(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS-normalize the trailing head_dim."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (sin, cos) each [..., head_dim // 2], f32. Made on
    ``positions``' device from a fill and ``arange`` (no host copy), so a
    CUDA graph can capture it."""
    half = head_dim // 2
    dev = positions.device
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=dev))
    freqs = torch.exp(-log_theta * (torch.arange(half, dtype=torch.float32, device=dev) / half))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [..., T, heads, head_dim]; sin/cos broadcastable to [..., T, 1, half]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Dense MLPs (plain matmuls: the reference leaves them to XLA, outside any
# Pallas kernel)
# ---------------------------------------------------------------------------
def init_mlp(kind: str, gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
             device) -> Params:
    if kind == "swiglu":
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device, fan_in=d_ff),
        }
    if kind == "gelu_mlp":
        return {
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device, fan_in=d_ff),
        }
    raise ValueError(f"unknown mlp {kind!r}")


def apply_mlp(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "gelu_mlp":
        return gelu(x @ p["w_up"]) @ p["w_down"]
    raise ValueError(f"unknown mlp {kind!r}")
