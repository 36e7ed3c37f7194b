"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The counterpart of ``repro/models/rglru.py``. Block: x -> [branch a: linear
-> causal conv1d(w) -> RG-LRU] * [branch b: linear -> gelu] -> linear out.
The diagonal linear recurrence ``h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t
* x_t)`` runs as a log-depth scan over the sequence at prefill (the
reference's ``lax.associative_scan``; here Hillis-Steele doubling, f32 as
there, so the sums group differently) and as one step at decode. The state
(``h`` [B, W] and the conv's last ``cw - 1`` inputs, both f32) is O(1) in
sequence length.

Casts follow the reference: the projections and the conv run in the
activation dtype (the conv over its f32 state cast to that dtype), the gate
weights ``w_rg`` / ``w_ig`` and ``lam`` stay f32 and so do the gates and the
scan; branch b is the tanh gelu (``layers.gelu``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import RecurrentConfig
from repro_torch.models.layers import Params, dense_init, gelu

State = Dict[str, torch.Tensor]

_C = 8.0  # Griffin's fixed recurrence-sharpness constant


def init_rglru(gen: torch.Generator, d_model: int, rcfg: RecurrentConfig, dtype: torch.dtype,
               device) -> Params:
    w = rcfg.lru_width or d_model
    # lambda so that a = sigmoid(lam)^c spreads over (0.9, 0.999)
    u = torch.empty((w,), dtype=torch.float32, device=device).uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(u ** (1.0 / _C) / (1.0 - u ** (1.0 / _C)))
    conv_w = torch.randn((rcfg.conv_width, w), dtype=torch.float32, device=device, generator=gen)
    return {
        "w_a": dense_init(gen, (d_model, w), dtype, device),          # branch a in-proj
        "w_b": dense_init(gen, (d_model, w), dtype, device),          # branch b (gate) in-proj
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_rg": dense_init(gen, (w, w), torch.float32, device),       # recurrence gate r_t
        "w_ig": dense_init(gen, (w, w), torch.float32, device),       # input gate i_t
        "lam": lam,
        "w_out": dense_init(gen, (w, d_model), dtype, device, fan_in=w),
    }


def rglru_zero_state(batch: int, d_model: int, rcfg: RecurrentConfig, device) -> State:
    w = rcfg.lru_width or d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, rcfg.conv_width - 1, w), dtype=torch.float32, device=device),
    }


def _causal_conv(p: Params, x: torch.Tensor,
                 conv_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, W]; conv_state [B, cw-1, W] holds the previous cw-1 inputs.
    Returns (conv output [B, S, W] in x's dtype, the new f32 state)."""
    cw, s = p["conv_w"].shape[0], x.shape[1]
    xf = torch.cat([conv_state.to(x.dtype), x], dim=1)              # [B, S+cw-1, W]
    out = xf[:, 0:s] * p["conv_w"][0]
    for i in range(1, cw):
        out = out + xf[:, i:i + s] * p["conv_w"][i]
    return out + p["conv_b"], xf[:, -(cw - 1):].float()


def _rglru_gates(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., W] (post-conv) -> (a_t, gated input), f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_rg"])
    i = torch.sigmoid(xf @ p["w_ig"])
    log_a = -_C * r * F.softplus(p["lam"])          # log a_t (a = sigmoid(lam)^(c*r))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xf)


def linear_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t over axis 1 with h_{-1} = 0, by doubling:
    after the step of distance d, (a_t, u_t) composes the last 2d inputs.
    log2(S) steps of whole-tensor operations."""
    s, d = a.shape[1], 1
    while d < s:
        u = torch.cat([u[:, :d], u[:, d:] + a[:, d:] * u[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u


def _rglru_inner(p: Params, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    """x [B, S, D] -> (y [B, S, D], new state)."""
    xa = x @ p["w_a"]
    xb = gelu(x @ p["w_b"])
    conv_out, conv_state = _causal_conv(p, xa, state["conv"])
    a, u = _rglru_gates(p, conv_out)                 # [B, S, W] each, f32
    u = torch.cat([u[:, :1] + a[:, :1] * state["h"][:, None], u[:, 1:]], dim=1)
    h = linear_scan(a, u)
    y = (h.to(x.dtype) * xb) @ p["w_out"]
    return y, {"h": h[:, -1], "conv": conv_state}


def rglru_prefill(p: Params, x: torch.Tensor, rcfg: RecurrentConfig) -> Tuple[torch.Tensor, State]:
    return _rglru_inner(p, x, rglru_zero_state(x.shape[0], x.shape[-1], rcfg, x.device))


def rglru_decode(p: Params, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    """x [B, 1, D]: one step of the recurrence."""
    assert x.shape[1] == 1
    xa = x @ p["w_a"]
    xb = gelu(x @ p["w_b"])
    conv_out, conv_state = _causal_conv(p, xa, state["conv"])
    a, u = _rglru_gates(p, conv_out)
    h = a[:, 0] * state["h"] + u[:, 0]
    y = (h[:, None].to(x.dtype) * xb) @ p["w_out"]
    return y, {"h": h, "conv": conv_state}

