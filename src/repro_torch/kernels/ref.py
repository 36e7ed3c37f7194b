"""Plain PyTorch versions of the kernels, in the reference's layouts.

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

from repro_torch.quant import dequantize_int4

NEG_INF = -1e30


def slot_gmm_ref(
    x: torch.Tensor,           # [G, C, D] per-group token rows
    w: torch.Tensor,           # [S+1, D, F] slot weights ([S+1, D/2, F] u8 if int4)
    lut: torch.Tensor,         # [G] int: the slot each group reads
    scale: Optional[torch.Tensor] = None,   # int8: [S+1, F] f32 | int4: [S+1, D/G, F] f16
    mn: Optional[torch.Tensor] = None,      # int4: [S+1, D/G, F] f16 group mins
) -> torch.Tensor:
    """out[g] = x[g] @ w[lut[g]], f32 accumulation. bf16/f32 weights: output
    in x's type. int8: the per-channel scale multiplies the f32 product; int4:
    the slots dequantize (``q * s + m`` in f32) before the product; both give
    f32 outputs."""
    idx = lut.long()
    if w.dtype == torch.uint8:
        wg = dequantize_int4(w.index_select(0, idx), scale.index_select(0, idx),
                             mn.index_select(0, idx))
        return torch.bmm(x.float(), wg)
    wg = w.index_select(0, idx).float()                       # [G, D, F]
    out = torch.bmm(x.float(), wg)
    if w.dtype == torch.int8:
        return out * scale.index_select(0, idx)[:, None, :]
    return out.to(x.dtype)


def slot_gmm_ragged_ref(
    x: torch.Tensor,           # [N, D] rows sorted by slot
    w: torch.Tensor,           # [S1, D, F] slot weights (the formats of slot_gmm_ref)
    offsets: torch.Tensor,     # [S1+1] int: rows offsets[s] .. offsets[s+1] read slot s
    scale: Optional[torch.Tensor] = None,
    mn: Optional[torch.Tensor] = None,
    *,
    miss_slot: Optional[int] = None,
) -> torch.Tensor:
    """out[r] = x[r] @ w[s] for the slot s whose rows hold r; rows of
    ``miss_slot`` (the MISS row) give zeros. One :func:`slot_gmm_ref` per
    slot that has rows (the counts come to the host: a plain version is
    never captured)."""
    n, f = x.shape[0], w.shape[2]
    quant = w.dtype in (torch.int8, torch.uint8)
    out = torch.zeros((n, f), dtype=torch.float32 if quant else x.dtype, device=x.device)
    bounds = offsets.tolist()
    for s in range(w.shape[0]):
        a, b = bounds[s], bounds[s + 1]
        if b > a and s != miss_slot:
            lut = torch.full((1,), s, dtype=torch.int32, device=x.device)
            out[a:b] = slot_gmm_ref(x[None, a:b], w, lut, scale, mn)[0]
    return out


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


def decode_attention_partial_ref(
    q: torch.Tensor,           # [B, H, dh]
    k: torch.Tensor,           # [B, S_loc, Hkv, dh] one slice of a cache split by sequence
    v: torch.Tensor,
    lengths: torch.Tensor,     # [B] int: the slice's valid positions, 0 .. S_loc
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """The partial entry's plain version: f32 [B, H, dh + 1], each head's
    softmax-normalized context over the slice's valid positions, then the
    log-sum-exp of its scores; an empty slice gives context 0 and lse
    ``-inf``."""
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, dh).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(dh)
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    valid = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, -float("inf")))
    lse = torch.logsumexp(logits, dim=-1)                         # -inf where empty
    probs = torch.exp(logits - torch.where(torch.isfinite(lse), lse,
                                           torch.zeros_like(lse))[..., None])
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return torch.cat([out.reshape(b, h, dh), lse.reshape(b, h, 1)], dim=-1)


def decode_attention_paged_ref(
    q: torch.Tensor,           # [B, H, dh]
    k: torch.Tensor,           # [P, ps, Hkv, dh] shared planes
    v: torch.Tensor,
    page_table: torch.Tensor,  # [B, n_pages] int plane pages of each row
    lengths: torch.Tensor,     # [B] int
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """The paged entry's plain version: each row's logical view gathered
    through its page table (the reference's ``k[page_table].reshape(B,
    cap, Hkv, dh)``), then :func:`decode_attention_ref`."""
    b, n_pages = page_table.shape
    tail = k.shape[2:]
    pt = page_table.long()
    kr = k[pt].reshape((b, n_pages * k.shape[1]) + tail)
    vr = v[pt].reshape((b, n_pages * v.shape[1]) + tail)
    return decode_attention_ref(q, kr, vr, lengths, soft_cap=soft_cap)


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


def router_topk_ref(
    h2: torch.Tensor,          # [T, D] bf16 or f32
    router: torch.Tensor,      # [D, E] f32
    k: int,
    *,
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router GEMM in f32 (the reference's ``router_logits``), then
    :func:`topk_gate_ref`."""
    return topk_gate_ref(h2.float() @ router, k, normalize=normalize)


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


def flash_attention_chunk_ref(
    q: torch.Tensor,           # [B, C, H, dh] at positions cur_len .. cur_len + C - 1
    k: torch.Tensor,           # [B, cap, Hkv, dh] the cache after the chunk's write
    v: torch.Tensor,
    cur_len,                   # int or integer scalar tensor
    *,
    window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of a chunk against a cache that holds position i at
    slot i (no wrap): query j at ``cur_len + j`` scores slots ``<= cur_len +
    j`` (and ``> cur_len + j - window``)."""
    b, c, h, dh = q.shape
    cap, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, c, hkv, g, dh).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    cl = torch.as_tensor(cur_len, device=q.device).to(torch.int64).reshape(())
    qpos = cl + torch.arange(c, device=q.device)
    kpos = torch.arange(cap, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, c, h, dh).to(q.dtype)


def flash_attention_chunk_partial_ref(
    q: torch.Tensor,           # [B, C, H, dh] at positions cur_len .. cur_len + C - 1
    k: torch.Tensor,           # [B, S_loc, Hkv, dh] one slice: positions offset .. offset + S_loc - 1
    v: torch.Tensor,
    cur_len,                   # int or integer scalar tensor
    offset: int,
    *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """The chunk entry's partial plain version over one slice of a cache
    split by sequence: query j at ``cur_len + j`` scores the slice's keys at
    positions ``<= cur_len + j`` (causal, no window). f32 [B, C, H, dh + 1]:
    each head's softmax-normalized context over those keys, then the
    log-sum-exp of its scores; a query that sees no key of the slice gives
    context 0 and lse ``-inf``."""
    b, c, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, c, hkv, g, dh).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    cl = torch.as_tensor(cur_len, device=q.device).to(torch.int64).reshape(())
    qpos = cl + torch.arange(c, device=q.device)
    kpos = offset + torch.arange(s, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                          # [C, S_loc]
    logits = torch.where(mask, logits, torch.full_like(logits, -float("inf")))
    lse = torch.logsumexp(logits, dim=-1)                          # [B, Hkv, g, C]
    probs = torch.exp(logits - torch.where(torch.isfinite(lse), lse,
                                           torch.zeros_like(lse))[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float()).reshape(b, c, h, dh)
    return torch.cat([out, lse.permute(0, 3, 1, 2).reshape(b, c, h, 1)], dim=-1)
