"""The forward pass's collectives over the tensor (model) axis: plain
functions on tensors, each with an explicit process group (the runtime the
reference gets from GSPMD when its ``param_spec`` splits a leaf).

* :func:`vocab_embed`: the vocabulary-parallel embedding. ``embed`` is
  stored at ``(tp, None)``: rank r holds rows ``[r V/tp, (r+1) V/tp)``; each
  rank looks up the tokens in its rows (the others give zero rows) and one
  ``all_reduce`` sums them. Exactly one rank adds a nonzero row, so the sum
  is the whole lookup bit for bit.
* the vocabulary-parallel head, ``lm_head`` at ``(None, tp)`` or the tied
  ``embed.T``, gives this rank's logits [..., V/tp];
  :func:`gather_vocab` all-gathers them where a caller needs all [..., V].
* :func:`merge_partials`: the cross-rank merge of split-KV decode
  partials, rows [tp, B, H, dh + 1] (each slice's normalized context and
  log-sum-exp, K2's partial entry), summed in fixed rank order, so every
  rank that merges the same rows holds the same bits.
* :func:`all_gather_dim`, :func:`all_reduce_`: the two collectives the
  sharded layers make (gloo takes both on CUDA tensors, staging them
  through host memory; NCCL takes them natively), and
  :func:`reduce_scatter_dim`, ZeRO-1's gradient reduction
  (``reduce_scatter_single``, ``reduce_scatter_tensor`` before it).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns it."""
    dist.all_reduce(x, group=group)
    return x


def all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """Row-parallel partial sums ``x`` summed over ``group`` in f32 and
    rounded to ``x``'s type once (a bf16 sum over ranks would round at every
    addition, on top of each partial's own rounding)."""
    if x.dtype == torch.float32:
        return all_reduce_(x, group)
    return all_reduce_(x.float(), group).to(x.dtype)


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def vocab_embed(embed_local: torch.Tensor, tokens: torch.Tensor, rank: int,
                group) -> torch.Tensor:
    """Token ids [...] -> embeddings [..., D] from this rank's rows
    ``embed_local`` [V/tp, D] (rank ``rank`` of the tensor axis): a masked
    lookup of the local rows, then one all-reduce."""
    v_loc = embed_local.shape[0]
    local = tokens.long() - rank * v_loc
    mine = (local >= 0) & (local < v_loc)
    x = embed_local[torch.where(mine, local, torch.zeros_like(local))]
    x = x * mine[..., None].to(x.dtype)
    return all_reduce_(x, group)


def gather_vocab(logits_local: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's logit columns, [..., V] in rank order."""
    return all_gather_dim(logits_local, logits_local.dim() - 1, group, size)


def merge_partials(parts: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Split-KV partials [tp, B, H, dh + 1] (each rank's slice: normalized
    context, then the log-sum-exp of its scores, ``-inf`` for an empty
    slice) -> the context over the whole cache [B, H, dh] in ``dtype``
    (default f32). Weights ``exp(lse_r - max_r lse_r)``, sums in rank
    order; an empty slice weighs 0."""
    o, lse = parts[..., :-1].float(), parts[..., -1].float()
    top = lse.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse - top)                                   # [tp, B, H]
    num = o[0] * w[0][..., None]
    den = w[0]
    for r in range(1, parts.shape[0]):
        num = num + o[r] * w[r][..., None]
        den = den + w[r]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out if dtype is None else out.to(dtype)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, this rank's 1/``size``
    slice of it along ``dim`` (``reduce_scatter_tensor`` on the dimension
    moved first), contiguous."""
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // size,) + tuple(xs.shape[1:]), dtype=xs.dtype,
                      device=xs.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, xs, group=group)
    return out.movedim(0, dim).contiguous()
