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

Training over the model axis differentiates through the collectives. Every
rank of the axis holds the same loss, so a gradient is summed over the
axis only where each rank's part covers its own share of the work
(Megatron's f and g): :func:`copy_to_tp` (identity forward, all-reduce
backward) where a replicated activation enters a split region,
:func:`reduce_from_tp` (the f32 all-reduce forward, identity backward)
where the partial sums leave it, :func:`gather_from_tp` (an all-gather
forward, this rank's slice of the gradient backward) and
:func:`count_once` (a value every rank computes
alike, its gradient passed by the axis' first rank alone). A replicated
leaf that a rank uses for its share only (``q_norm`` under a head split,
the router under expert parallelism) gets a partial gradient that the
trainer sums; :func:`torch.distributed.nn.functional.all_reduce` would
sum every gradient, already whole, tp times. :func:`gather_at_use` is FSDP's:
an all-gather over the data axis forward, a reduce-scatter (the data
ranks' gradients summed) backward. :func:`vocab_parallel_xent` is the
cross-entropy over logits split by vocabulary.
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
    lookup of the local rows, then one all-reduce (:func:`reduce_from_tp`
    in the rows' type: one rank adds each nonzero row). Differentiable: the
    backward scatters into this rank's rows only."""
    v_loc = embed_local.shape[0]
    local = tokens.long() - rank * v_loc
    mine = (local >= 0) & (local < v_loc)
    x = embed_local[torch.where(mine, local, torch.zeros_like(local))]
    x = x * mine[..., None].to(x.dtype)
    return reduce_from_tp(x, group, f32=False)


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


# ---------------------------------------------------------------------------
# Collectives with a backward (training over the model axis, FSDP)
# ---------------------------------------------------------------------------
def _summed(x: torch.Tensor, group, f32: bool = True) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group`` (in f32 and rounded once to
    x's type with ``f32``), ``x`` itself untouched."""
    out = x.to(torch.float32 if f32 else x.dtype, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, f32):
        return _summed(x, group, f32)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return all_gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None, None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return all_gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.size), None, None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a region split over ``group``:
    identity forward; backward, the ranks' partial gradients summed (f32)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group, f32: bool = True) -> torch.Tensor:
    """The ranks' partial sums ``x`` summed over ``group`` (in f32 and
    rounded once, as :func:`all_reduce_f32`; in x's type with ``f32=False``);
    backward, the gradient passed on as it is (every rank holds it whole)."""
    return _ReduceFromTP.apply(x, group, f32)


def gather_from_tp(x: torch.Tensor, dim: int, group, size: int, rank: int) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim`` in rank order; backward,
    this rank's slice of the gradient."""
    return _GatherFromTP.apply(x, dim, group, size, rank)


def count_once(x: torch.Tensor, rank: int) -> torch.Tensor:
    """A value every rank of an axis computes alike from replicated inputs
    (the MoE aux losses): identity forward; backward, the gradient on the
    axis' rank 0 and zero elsewhere, so a sum over the axis counts it once,
    exactly."""
    return _CountOnce.apply(x, rank == 0)


def gather_at_use(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """An FSDP shard gathered whole along ``dim`` over the data ``group``
    (forward all-gather); backward, the data ranks' gradients summed and
    this rank's shard kept (:func:`reduce_scatter_dim`)."""
    return _GatherAtUse.apply(x, dim, group, size)


class _VocabXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, rank, group):
        v_loc = logits.shape[-1]
        top = logits.detach().amax(dim=-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - top[..., None])
        local = targets.long() - rank * v_loc
        mine = (local >= 0) & (local < v_loc)
        idx = torch.where(mine, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        sums = torch.stack([e.sum(dim=-1), torch.where(mine, gold, torch.zeros_like(gold))])
        dist.all_reduce(sums, group=group)
        ctx.save_for_backward(e / sums[0][..., None], idx, mine)
        return torch.log(sums[0]) + top - sums[1]

    @staticmethod
    def backward(ctx, g):
        probs, idx, mine = ctx.saved_tensors
        grad = probs * g[..., None]
        hit = (g * mine.to(g.dtype))[..., None]
        return grad.scatter_add(-1, idx[..., None], -hit), None, None, None


def vocab_parallel_xent(logits_local: torch.Tensor, targets: torch.Tensor, rank: int,
                        group) -> torch.Tensor:
    """Per-position cross-entropy ``logsumexp(logits) - logits[target]`` from
    this rank's f32 logit columns [..., V/tp] (vocabulary rows
    ``[rank V/tp, (rank+1) V/tp)``; a target < 0 scores any value, the
    caller masks it): an all-reduce of the row maxima, then one of the sums
    of exponents and the gold logit (nonzero on its owner rank). Backward,
    this rank's softmax columns minus its share of the one-hot."""
    return _VocabXent.apply(logits_local, targets, rank, group)
