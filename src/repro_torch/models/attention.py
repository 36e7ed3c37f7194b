"""Grouped-query attention: prefill and decode against a fixed-capacity cache.

The counterpart of ``repro/models/attention.py`` for the paths the rotary
engine runs. Prefill scores the prompt with the flash-attention kernel (K4)
and emits a ``cache_len`` cache; decode writes the new token's K/V at slot
``cur_len % cap`` IN PLACE (the reference returns a new cache; here the
engine's per-layer cache tensors are updated where they lie) and then scores
with the flash-decode kernel (K2), which reads ``cur_len + 1`` positions.
Sliding-window (ring) caches keep the reference's plain masked path: their
slot order is not position order, which K2 does not model.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.config.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    Params, apply_rope, dense_init, rms_norm_headdim, rope_angles,
)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, acfg: AttentionConfig,
                   dtype: torch.dtype, device) -> Params:
    h, hkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    p: Params = {
        "wq": dense_init(gen, (d_model, h * dh), dtype, device),
        "wk": dense_init(gen, (d_model, hkv * dh), dtype, device),
        "wv": dense_init(gen, (d_model, hkv * dh), dtype, device),
        "wo": dense_init(gen, (h * dh, d_model), dtype, device, fan_in=h * dh),
    }
    if acfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=device)
    return p


def _project_qkv(
    p: Params, acfg: AttentionConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> q [B, S, H, dh], k/v [B, S, Hkv, dh] with RoPE + optional qk-norm."""
    b, s, _ = x.shape
    h, hkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if acfg.qk_norm:
        q = rms_norm_headdim(p["q_norm"], q)
        k = rms_norm_headdim(p["k_norm"], k)
    sin, cos = rope_angles(positions, dh, acfg.rope_theta)    # [B?, S, dh/2]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def cache_capacity(acfg: AttentionConfig, cache_len: int) -> int:
    if acfg.window is not None:
        return min(acfg.window, cache_len)
    return cache_len


def zero_cache(acfg: AttentionConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    shape = (batch, cache_capacity(acfg, cache_len), acfg.num_kv_heads, acfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(
    p: Params, acfg: AttentionConfig, x: torch.Tensor, cache_len: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: causal attention (K4) + a fixed-capacity KV cache of
    ``cache_len`` (ring-indexed, slot = pos % cap, for windowed attention)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, acfg, x, positions)
    ctx = ops.flash_attention(
        q, k, v, causal=True, window=acfg.window, soft_cap=acfg.logit_soft_cap
    )
    y = ctx.reshape(b, s, -1) @ p["wo"]
    cache = zero_cache(acfg, b, cache_len, k.dtype, x.device)
    cap = cache["k"].shape[1]
    if acfg.window is not None and s > cap:
        slots = (s - cap + torch.arange(cap, device=x.device)) % cap
        cache["k"][:, slots] = k[:, -cap:]
        cache["v"][:, slots] = v[:, -cap:]
    else:
        n = min(s, cap)
        cache["k"][:, :n] = k[:, :n]
        cache["v"][:, :n] = v[:, :n]
    return y, cache


def attention_decode(
    p: Params, acfg: AttentionConfig, x: torch.Tensor,
    cache: Dict[str, torch.Tensor], cur_len: int,
) -> torch.Tensor:
    """One-token decode. x [B, 1, D]; cache k/v [B, cap, Hkv, dh], updated IN
    PLACE at slot ``cur_len % cap`` before scoring. Returns y [B, 1, D].

    Re-running this at the same ``cur_len`` (the engine's suffix replay)
    overwrites the very slot the first pass wrote, as in the reference."""
    b = x.shape[0]
    h, hkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    positions = torch.full((b, 1), cur_len, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, acfg, x, positions)
    ck, cv = cache["k"], cache["v"]
    cap = ck.shape[1]
    slot = cur_len % cap
    ck[:, slot] = k_new[:, 0]
    cv[:, slot] = v_new[:, 0]
    if acfg.window is None:
        ctx = ops.decode_attention(q, ck, cv, cur_len=cur_len, soft_cap=acfg.logit_soft_cap)
    else:
        ctx = _ring_decode_plain(acfg, q, ck, cv, cur_len)
    return ctx.reshape(b, 1, h * dh) @ p["wo"]


def _ring_decode_plain(acfg: AttentionConfig, q: torch.Tensor, ck: torch.Tensor,
                       cv: torch.Tensor, cur_len: int) -> torch.Tensor:
    """The reference's masked decode over a ring cache (``attention.py:442-467``):
    slots ahead of the write head hold the previous lap's positions."""
    b, _, h, dh = q.shape
    hkv, cap = acfg.num_kv_heads, ck.shape[1]
    g = h // hkv
    qg = q.reshape(b, 1, hkv, g, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) / math.sqrt(dh)
    if acfg.logit_soft_cap is not None:
        s = acfg.logit_soft_cap * torch.tanh(s / acfg.logit_soft_cap)
    idx = torch.arange(cap, device=q.device)
    lap = (cur_len // cap) * cap
    kpos = torch.where(idx <= cur_len % cap, lap + idx, lap - cap + idx)
    valid = (kpos <= cur_len) & (kpos >= 0) & (kpos > cur_len - acfg.window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.float())
    return ctx.reshape(b, 1, h, dh).to(q.dtype)
