"""Grouped-query attention: prefill and decode against a fixed-capacity cache.

The counterpart of ``repro/models/attention.py`` for the paths the rotary
engine runs. Prefill scores the prompt with the flash-attention kernel (K4)
and writes a ``cache_len`` cache (into the caller's cache when it owns one);
decode writes the new token's K/V at slot ``cur_len % cap`` IN PLACE (the
reference returns a new cache; here the engine's per-layer cache tensors are
updated where they lie) and then scores with the flash-decode kernel (K2),
which reads ``min(cur_len + 1, cap)`` positions. ``cur_len`` may be a device
scalar, so a CUDA graph can capture the step and the host set the position
before each replay.

Chunked prefill (``attention_prefill_chunk``) appends a chunk of C positions
to the same caches in place and scores them with K4's chunk-append entry,
``cur_len`` again a device scalar, so one CUDA graph per chunk length serves
every chunk start.

The serving engine's paged pool (``attention_decode(page_table=...)``, per
row ``cur_len`` [B]) writes each row's new K/V through its page table into
planes shared by every row and scores them with K2's paged entry, which
reads the pages through the table itself.

Training (``attention_train``) runs no kernel: K4 has no backward (the
reference trains with ``use_pallas=False``), so it scores with the
reference's plain forms, ``reference_attention`` (the whole [S, S] score
matrix, up to ``max(q_chunk, 128)`` positions) or ``chunked_attention``
(the flash dataflow in plain PyTorch: an online softmax over KV chunks,
unreachable chunk pairs skipped), both with bf16 operands upcast to f32
sums as the reference's ``preferred_element_type=f32`` does.

Sliding-window (ring) caches need no ring mask in K2: the cache holds
``cap = min(window, cache_len)`` slots, and after the write every filled
slot holds a position in ``(cur_len - cap, cur_len]``, inside the window, so
scoring the filled slots in slot order scores the reference's set
(``_ring_decode_plain``, its masked path, stays as the plain version the
tests hold K2 to).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

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
    """x [B, S, D] -> q [B, S, H, dh], k/v [B, S, Hkv, dh] with RoPE + optional qk-norm.
    The head counts are the projections' (``wq`` / ``wk`` columns over dh):
    a rank of the tensor axis holding its heads' columns projects those."""
    b, s, _ = x.shape
    dh = acfg.head_dim
    h, hkv = p["wq"].shape[1] // dh, p["wk"].shape[1] // dh
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


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    m = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _scores(qg: torch.Tensor, k: torch.Tensor, soft_cap: Optional[float]) -> torch.Tensor:
    """qg [B, Sq, Hkv, g, dh], k [B, Skv, Hkv, dh] -> f32 logits [B, Hkv, g, Sq, Skv]."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(qg.shape[-1])
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    return s


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        soft_cap: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """The reference's O(S^2)-memory attention: q [B, Sq, H, dh], k/v [B,
    Skv, Hkv, dh] -> [B, Sq, H, dh] in q's type; f32 logits and softmax, the
    probabilities cast to v's type before the value sum."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    s = _scores(q.reshape(b, sq, hkv, h // hkv, dh), k, soft_cap)
    qpos = torch.arange(sq, device=q.device) + q_offset
    mask = _mask(qpos, torch.arange(skv, device=q.device), causal, window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      soft_cap: Optional[float] = None, q_chunk: int = 512,
                      kv_chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """The reference's flash-dataflow attention: per q chunk, an online
    softmax over the KV chunks, O(q_chunk * kv_chunk) scores at once; a
    (q chunk, KV chunk) pair that the causal or window mask empties is
    skipped (decided on the host: the chunk starts are static)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"seq lens ({sq},{skv}) must divide chunks ({q_chunk},{kv_chunk})")
    outs = []
    for q_start in range(0, sq, q_chunk):
        qs = q_start + q_offset
        qblk = q[:, q_start:q_start + q_chunk].reshape(b, q_chunk, hkv, g, dh)
        qpos = qs + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, q_chunk, dh), dtype=torch.float32, device=q.device)
        for k_start in range(0, skv, kv_chunk):
            if causal and k_start > qs + q_chunk - 1:
                continue
            if window is not None and k_start + kv_chunk - 1 <= qs - window:
                continue
            s = _scores(qblk, k[:, k_start:k_start + kv_chunk], soft_cap)
            kpos = k_start + torch.arange(kv_chunk, device=q.device)
            s = torch.where(_mask(qpos, kpos, causal, window), s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            vblk = v[:, k_start:k_start + kv_chunk]
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pr.to(vblk.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))                  # [B, qc, Hkv, g, dh]
    return torch.cat(outs, dim=1).reshape(b, sq, h, dh)


def attention_train(p: Params, acfg: AttentionConfig, x: torch.Tensor, *,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Full-sequence causal attention for training, x [B, S, D] -> [B, S, D]:
    ``reference_attention`` up to ``max(q_chunk, 128)`` positions, else
    ``chunked_attention`` (the reference's ``attention_train`` without
    ``use_pallas``). No kernel, no cache, nothing written in place."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, acfg, x, torch.arange(s, device=x.device)[None, :])
    kw = dict(causal=True, window=acfg.window, soft_cap=acfg.logit_soft_cap)
    if s <= max(q_chunk, 128):
        ctx = reference_attention(q, k, v, **kw)
    else:
        ctx = chunked_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
    return ctx.reshape(b, s, -1) @ p["wo"]


def attention_prefill(
    p: Params, acfg: AttentionConfig, x: torch.Tensor, cache_len: int,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: causal attention (K4) + a fixed-capacity KV cache of
    ``cache_len`` (ring-indexed, slot = pos % cap, for windowed attention).
    ``cache`` (as ``zero_cache`` makes it) is zeroed and written in place, so
    its owner keeps one allocation across requests; None makes a new one."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, acfg, x, positions)
    ctx = ops.flash_attention(
        q, k, v, causal=True, window=acfg.window, soft_cap=acfg.logit_soft_cap
    )
    y = ctx.reshape(b, s, -1) @ p["wo"]
    return y, write_cache(acfg, k, v, cache_len, cache)


def write_cache(acfg: AttentionConfig, k: torch.Tensor, v: torch.Tensor, cache_len: int,
                cache: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """A prefill's K/V [B, S, Hkv, dh] into a ``cache_len`` cache: ``cache``
    zeroed and written in place (None: a new one); a window's ring cache
    holds the last ``cap`` positions at slots ``pos % cap``."""
    b, s = k.shape[0], k.shape[1]
    if cache is None:
        cache = zero_cache(acfg, b, cache_len, k.dtype, k.device)
    else:
        cache["k"].zero_()
        cache["v"].zero_()
    cap = cache["k"].shape[1]
    if acfg.window is not None and s > cap:
        slots = (s - cap + torch.arange(cap, device=k.device)) % cap
        cache["k"][:, slots] = k[:, -cap:]
        cache["v"][:, slots] = v[:, -cap:]
    else:
        n = min(s, cap)
        cache["k"][:, :n] = k[:, :n]
        cache["v"][:, :n] = v[:, :n]
    return cache


def attention_prefill_chunk(
    p: Params, acfg: AttentionConfig, x: torch.Tensor,
    cache: Dict[str, torch.Tensor], cur_len: Union[int, torch.Tensor],
) -> torch.Tensor:
    """Chunked prefill: append ``C`` positions to the cache IN PLACE and attend
    against everything cached so far, the chunk included. x [B, C, D]; cache
    k/v [B, cap, Hkv, dh]; ``cur_len`` = tokens already cached (an int or an
    integer scalar on x's device). The chunk's K/V go to slots ``(cur_len +
    j) % cap``. Returns y [B, C, D].

    A window-free cache scores the post-write cache, where slot i holds
    position i (K4's chunk-append entry on the card). A ring cache on the
    CPU keeps the reference's semantics: the PRE-write cache concatenated
    with the chunk's own K/V, so a previous-lap entry a chunk write
    overwrites stays visible to the chunk's earlier queries
    (``_ring_chunk_plain``). On the card a ring cache also takes the kernel,
    which assumes the chunk does not wrap (``cur_len + C <= cap``, slot ==
    position, where both semantics agree): a device ``cur_len`` cannot be
    checked here, so the engine checks it on the host before each launch."""
    b, c, _ = x.shape
    ck, cv = cache["k"], cache["v"]
    cap = ck.shape[1]
    if c > cap:
        raise ValueError(f"prefill chunk ({c}) exceeds KV capacity ({cap})")
    on_card = x.device.type == "cuda"
    if not isinstance(cur_len, torch.Tensor):
        if on_card and cur_len + c > cap:
            raise ValueError(f"a chunk at {cur_len} + {c} wraps the KV cache ({cap})")
        cur_len = torch.full((), cur_len, dtype=torch.int64, device=x.device)
    cl = cur_len.to(torch.int64).reshape(())
    qpos = cl + torch.arange(c, device=x.device)                        # [C]
    q, k_new, v_new = _project_qkv(p, acfg, x, qpos[None, :])
    ring = acfg.window is not None and not on_card
    if ring:
        pre = (ck.clone(), cv.clone())
    slots = torch.remainder(qpos, cap)
    ck.index_copy_(1, slots, k_new)
    cv.index_copy_(1, slots, v_new)
    if ring:
        ctx = _ring_chunk_plain(acfg, q, *pre, k_new, v_new, cl)
    else:
        ctx = ops.flash_attention_chunk(q, ck, cv, cl, window=acfg.window,
                                        soft_cap=acfg.logit_soft_cap)
    return ctx.reshape(b, c, -1) @ p["wo"]


def _ring_chunk_plain(acfg: AttentionConfig, q: torch.Tensor, pre_k: torch.Tensor,
                      pre_v: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      cl: torch.Tensor) -> torch.Tensor:
    """The reference's ring-cache chunk scoring (``attention.py:349-372``):
    the pre-write cache, whose slot i holds the newest position < ``cl``
    congruent to i (negative, so masked, where never written), concatenated
    with the chunk's K/V; causal and window masks on those positions."""
    b, c, h, dh = q.shape
    hkv, cap = acfg.num_kv_heads, pre_k.shape[1]
    g = h // hkv
    k_all = torch.cat([pre_k, k_new], dim=1).float()
    v_all = torch.cat([pre_v, v_new], dim=1).float()
    idx = torch.arange(cap, device=q.device)
    end0 = cl - 1
    qpos = cl + torch.arange(c, device=q.device)
    kpos = torch.cat([end0 - torch.remainder(end0 - idx, cap), qpos])          # [cap + C]
    qg = q.reshape(b, c, hkv, g, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_all) / math.sqrt(dh)
    if acfg.logit_soft_cap is not None:
        s = acfg.logit_soft_cap * torch.tanh(s / acfg.logit_soft_cap)
    valid = ((kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
             & (kpos[None, :] > qpos[:, None] - acfg.window))
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_all)
    return ctx.reshape(b, c, h, dh).to(q.dtype)


def attention_decode(
    p: Params, acfg: AttentionConfig, x: torch.Tensor,
    cache: Dict[str, torch.Tensor], cur_len: Union[int, torch.Tensor],
    page_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token decode. x [B, 1, D]; cache k/v [B, cap, Hkv, dh], updated IN
    PLACE at slot ``cur_len % cap`` before scoring. Returns y [B, 1, D].
    ``cur_len`` is an int or an integer tensor on x's device, a scalar or
    per row [B] (the serving engine's ragged rows): each row writes its own
    slot and rotates at its own position. A device ``cur_len`` stays there,
    so a CUDA graph can capture the write.

    ``page_table`` [B, cap // ps] int32 switches the cache to the serving
    engine's paged pool (the reference's ``page_table=``): k/v are planes
    [P, ps, Hkv, dh] shared by every row, and row b's slot s lives at
    ``(page_table[b, s // ps], s % ps)``. The new K/V go there; scoring
    reads the row's pages through the table (K2's paged entry on the card;
    on the CPU the row's gathered logical view, scored as the contiguous
    path scores it, so paged decode is bitwise the contiguous decode).
    Pad rows carry all-zero tables: their writes land in the scratch page 0,
    never scored unmasked.

    Re-running this at the same ``cur_len`` (the engine's suffix replay and
    miss relaunch) overwrites the very slot the first pass wrote, as in the
    reference."""
    b = x.shape[0]
    h, hkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    ck, cv = cache["k"], cache["v"]
    cl = torch.as_tensor(cur_len, device=x.device).to(torch.int64).reshape(-1).expand(b)
    q, k_new, v_new = _project_qkv(p, acfg, x, cl[:, None])
    if page_table is None:
        cap = ck.shape[1]
        slot = torch.remainder(cl, cap)
        where = (torch.arange(b, device=x.device), slot)
    else:
        ps = ck.shape[1]
        cap = page_table.shape[1] * ps
        slot = torch.remainder(cl, cap)
        page = torch.gather(page_table.long(), 1,
                            torch.div(slot, ps, rounding_mode="floor")[:, None])[:, 0]
        where = (page, torch.remainder(slot, ps))
    ck.index_put_(where, k_new[:, 0])
    cv.index_put_(where, v_new[:, 0])
    lengths = torch.clamp(cl.to(torch.int32) + 1, max=cap)
    ctx = ops.decode_attention(q, ck, cv, lengths=lengths, soft_cap=acfg.logit_soft_cap,
                               page_table=page_table)
    return ctx.reshape(b, 1, h * dh) @ p["wo"]


def _ring_decode_plain(acfg: AttentionConfig, q: torch.Tensor, ck: torch.Tensor,
                       cv: torch.Tensor, cur_len: int) -> torch.Tensor:
    """The reference's masked decode over a ring cache (``attention.py:442-467``):
    slots ahead of the write head hold the previous lap's positions. The
    plain version K2's ring scoring is held to (``attention_decode`` scores
    the filled slots without this mask)."""
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
