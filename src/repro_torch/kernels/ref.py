"""Plain PyTorch versions of the four kernels, in the reference's layouts.

Each function computes what its CUDA kernel computes, written for clarity:
the CPU path of ``kernels/ops.py`` runs these, the tests hold them against
the JAX package's Pallas kernels (interpret mode), and ``chip_smoke.py``
holds each CUDA kernel against them on the card. They are not yardsticks of
speed.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def slot_gmm_ref(
    x: torch.Tensor,           # [G, C, D] per-group token rows
    w: torch.Tensor,           # [S+1, D, F] slot weights (slot S = zero MISS slot)
    lut: torch.Tensor,         # [G] int: the slot each group reads
) -> torch.Tensor:
    """out[g] = x[g] @ w[lut[g]], f32 accumulation, output in x's type."""
    wg = w.index_select(0, lut.long()).float()                 # [G, D, F]
    return torch.bmm(x.float(), wg).to(x.dtype)


def decode_attention_ref(
    q: torch.Tensor,           # [B, H, dh] one new token per row
    k: torch.Tensor,           # [B, S, Hkv, dh]
    v: torch.Tensor,
    lengths: torch.Tensor,     # [B] int: valid cache positions (cur_len + 1)
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, dh).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(dh)
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]        # [B, S]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(b, h, dh).to(q.dtype)


def topk_gate_ref(
    logits: torch.Tensor,      # [T, E]
    k: int,
    *,
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax, then ``k`` rounds of argmax with the LOWEST index winning
    ties (the reference's ``lax.top_k`` order), then optional renormalization.
    Returns (ids int32 [T, k], weights f32 [T, k])."""
    probs = torch.softmax(logits.float(), dim=-1)
    t, e = probs.shape
    cols = torch.arange(e, device=probs.device).expand(t, e)
    work = probs.clone()
    ids, ws = [], []
    for _ in range(k):
        w = work.max(dim=-1).values
        idx = torch.where(work >= w[:, None], cols, e).min(dim=-1).values
        ids.append(idx)
        ws.append(w)
        work = torch.where(cols == idx[:, None], torch.full_like(work, -1.0), work)
    ids_t = torch.stack(ids, dim=-1).to(torch.int32)
    w_t = torch.stack(ws, dim=-1)
    if normalize:
        w_t = w_t / torch.clamp(w_t.sum(-1, keepdim=True), min=1e-9)
    return ids_t, w_t


def flash_attention_ref(
    q: torch.Tensor,           # [B, Sq, H, dh]
    k: torch.Tensor,           # [B, Skv, Hkv, dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Naive O(S^2)-memory attention (the reference's ``reference_attention``)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)
