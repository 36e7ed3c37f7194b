"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) [arXiv:2405.04517].

The counterpart of ``repro/models/xlstm.py``. Both cells use exponential
gating with the max-stabilizer (``m`` starts at -1e30). Prefill runs the
cell over time, one position after another (the reference's ``lax.scan``);
decode is the same cell once, so a decode after a prefill equals a prefill
over the longer sequence. States are O(1) in sequence length and f32.

The reference has no Pallas kernel here (a scan of jnp operations), so the
port is plain PyTorch, as for the dense MLPs. Casts follow the reference:
projections in the activation dtype, the gate weights (``w_if``, ``b_if``,
sLSTM's ``w_in``, ``r``, ``b``) and the cells in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import RecurrentConfig
from repro_torch.models.layers import Params, dense_init, gelu

State = Dict[str, torch.Tensor]

M_INIT = -1e30          # the stabilizer's start: the first gate sets m


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


# ===========================================================================
# mLSTM
# ===========================================================================
def init_mlstm(gen: torch.Generator, d_model: int, rcfg: RecurrentConfig, dtype: torch.dtype,
               device) -> Params:
    h = rcfg.num_heads
    d_inner = 2 * d_model
    b_if = torch.cat([torch.zeros((h,)), torch.full((h,), 3.0)]).to(device)
    return {
        "w_up": dense_init(gen, (d_model, 2 * d_inner), dtype, device),  # cell | gate branch
        "w_q": dense_init(gen, (d_inner, d_inner), dtype, device),
        "w_k": dense_init(gen, (d_inner, d_inner), dtype, device),
        "w_v": dense_init(gen, (d_inner, d_inner), dtype, device),
        "w_if": dense_init(gen, (d_inner, 2 * h), torch.float32, device),  # i, f pre-activations
        "b_if": b_if,                                                       # [i | f]
        "skip": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_inner, d_model), dtype, device, fan_in=d_inner),
    }


def mlstm_zero_state(batch: int, d_model: int, rcfg: RecurrentConfig, device) -> State:
    h = rcfg.num_heads
    dh = (2 * d_model) // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), M_INIT, **f32)}


def _mlstm_cell(state: State, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_pre: torch.Tensor, f_pre: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """One step. q/k/v [B, H, dh] f32; i/f pre-activations [B, H]. Returns
    (new state, h [B, H, dh])."""
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    k_scaled = k / math.sqrt(q.shape[-1])
    c = f_g[..., None, None] * state["c"] + i_g[..., None, None] * (
        v[..., :, None] * k_scaled[..., None, :])
    n = f_g[..., None] * state["n"] + i_g[..., None] * k_scaled
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return {"c": c, "n": n, "m": m_new}, num / den[..., None]


def _mlstm_project(p: Params, x: torch.Tensor):
    """x [B, S, D] -> (cell_in, gate_in [B, S, 2D], q/k/v [B, S, H, dh] f32,
    i/f pre-activations [B, S, H] f32)."""
    b, s, _ = x.shape
    cell_in, gate_in = (x @ p["w_up"]).chunk(2, dim=-1)
    hh = p["b_if"].shape[0] // 2
    dh = cell_in.shape[-1] // hh
    q, k, v = ((cell_in @ p[n]).reshape(b, s, hh, dh).float() for n in ("w_q", "w_k", "w_v"))
    i_pre, f_pre = (cell_in.float() @ p["w_if"] + p["b_if"]).chunk(2, dim=-1)
    return cell_in, gate_in, q, k, v, i_pre, f_pre


def _mlstm_out(p: Params, x: torch.Tensor, hs: torch.Tensor, cell_in: torch.Tensor,
               gate_in: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h_seq = hs.reshape(b, s, -1).to(x.dtype) + p["skip"] * cell_in
    return (h_seq * F.silu(gate_in)) @ p["w_down"]


def mlstm_prefill(p: Params, x: torch.Tensor, rcfg: RecurrentConfig) -> Tuple[torch.Tensor, State]:
    """x [B, S, D] from the zero state -> (y [B, S, D], state)."""
    state = mlstm_zero_state(x.shape[0], x.shape[-1], rcfg, x.device)
    cell_in, gate_in, q, k, v, i_pre, f_pre = _mlstm_project(p, x)
    hs = []
    for t in range(x.shape[1]):
        state, h_out = _mlstm_cell(state, q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        hs.append(h_out)
    return _mlstm_out(p, x, torch.stack(hs, dim=1), cell_in, gate_in), state


def mlstm_decode(p: Params, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    """x [B, 1, D]: one step."""
    assert x.shape[1] == 1
    cell_in, gate_in, q, k, v, i_pre, f_pre = _mlstm_project(p, x)
    state, h_out = _mlstm_cell(state, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
    return _mlstm_out(p, x, h_out[:, None], cell_in, gate_in), state


# ===========================================================================
# sLSTM
# ===========================================================================
def init_slstm(gen: torch.Generator, d_model: int, rcfg: RecurrentConfig, dtype: torch.dtype,
               device) -> Params:
    h = rcfg.num_heads
    dh = d_model // h
    up = (4 * d_model) // 3
    r = torch.randn((4, h, dh, dh), dtype=torch.float32, device=device, generator=gen)
    b = torch.cat([torch.zeros((2 * d_model,)), torch.full((d_model,), 3.0),
                   torch.zeros((d_model,))]).to(device)
    return {
        "w_in": dense_init(gen, (d_model, 4 * d_model), torch.float32, device),  # z, i, f, o
        "r": r / math.sqrt(dh),                   # block-diagonal recurrent weights per head
        "b": b,
        "w_up": dense_init(gen, (d_model, 2 * up), dtype, device),     # post-cell GLU MLP
        "w_down": dense_init(gen, (up, d_model), dtype, device, fan_in=up),
    }


def slstm_zero_state(batch: int, d_model: int, rcfg: RecurrentConfig, device) -> State:
    h = rcfg.num_heads
    shape = (batch, h, d_model // h)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32), "m": torch.full(shape, M_INIT, **f32)}


def _slstm_cell(p: Params, state: State, pre: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """pre = x_t @ w_in + b [B, 4D] f32 -> (new state, h [B, D])."""
    b = pre.shape[0]
    _, h, dh, _ = p["r"].shape
    rec = torch.einsum("bhd,ghde->bghe", state["h"], p["r"])          # [B, 4, H, dh]
    z_pre, i_pre, f_pre, o_pre = (pre.reshape(b, 4, h, dh) + rec).unbind(1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c = f_g * state["c"] + i_g * z
    n = f_g * state["n"] + i_g
    h_new = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h_new, "m": m_new}, h_new.reshape(b, h * dh)


def _slstm_out(p: Params, x: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    a, g = (hs.to(x.dtype) @ p["w_up"]).chunk(2, dim=-1)
    return (a * gelu(g)) @ p["w_down"]


def slstm_prefill(p: Params, x: torch.Tensor, rcfg: RecurrentConfig) -> Tuple[torch.Tensor, State]:
    """x [B, S, D] from the zero state -> (y [B, S, D], state)."""
    state = slstm_zero_state(x.shape[0], x.shape[-1], rcfg, x.device)
    pre = x.float() @ p["w_in"] + p["b"]                                # [B, S, 4D]
    hs = []
    for t in range(x.shape[1]):
        state, h_out = _slstm_cell(p, state, pre[:, t])
        hs.append(h_out)
    return _slstm_out(p, x, torch.stack(hs, dim=1)), state


def slstm_decode(p: Params, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    """x [B, 1, D]: one step."""
    assert x.shape[1] == 1
    state, h_out = _slstm_cell(p, state, x[:, 0].float() @ p["w_in"] + p["b"])
    return _slstm_out(p, x, h_out[:, None]), state
