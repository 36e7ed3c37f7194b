"""Decoder assembly for the engine path: init, per-layer decode state, the
decode step over the layer stack, and the lm head.

The counterpart of ``repro/models/transformer.py`` for every block kind:
``attn_mlp`` / ``local_attn`` (attention, full or sliding-window, + dense
MLP), ``attn_moe`` (attention + MoE) and the recurrent kinds ``rglru``
(RG-LRU + dense MLP), ``mlstm`` and ``slstm`` (xLSTM cells). Parameters are
plain dicts of tensors: ``embed``, ``final_norm``, ``lm_head`` (untied
configs), ``frontend_proj`` (a frontend whose width is not ``d_model``) and
``layers``, a list with one dict per layer (the reference stacks repeated
layers for its ``lax.scan``; a Python loop over layers needs no stacking).
Residency, routing telemetry and the prefill's expert callbacks count MoE
layers only (their ordinal among the ``attn_moe`` layers), as the
reference's ``moe_segments`` order does; a dense stack routes nothing and
returns no telemetry. A frontend arch (``cfg.frontend``) prepends its
precomputed embeddings to the prompt at prefill (``frontend=``), so they
take the first cache positions.

The decode state is a list with one dict per layer: ``{"k", "v"}`` caches
for the KV kinds, the cell's f32 state for a recurrent one; decode updates
both in place (``copy_`` for a recurrent state, so a CUDA graph's
addresses hold). The speculative window (``decode_window``, greedy or
sampled) and its KV snapshot / rollback follow the reference's
``decode_window``, ``snapshot_kv_window`` and ``rollback_kv_window`` and
touch KV layers only (a recurrent update cannot be rolled back, so the
engines run windows on KV-only stacks); a prefill chunk
(``prefill_chunk_model``) appends C positions to the same caches, the
reference's ``prefill_chunk_model``, and raises on a recurrent layer.

The serving engine's paged KV pool (``paged_zero_state``: per layer, planes
[P, ps, Hkv, dh] shared by every row; KV-only stacks) runs through the same
decode step and window with a ``page_table`` [B, pages] and a per-row
``cur_len`` [B]. Its admission prefill is ``prefill_model``: each row at its
exact length (``last_index``), so neither a pad nor another row's length
reaches a row's logits or state. Its MoE half is dropless, as the engines'
decode is; ``moe_capacity`` drops what the reference's sorted dispatch
drops at that capacity (a row alone, pads sorted after its tokens).

An eager ``decode_model`` caller fixes the row count by the state it
allocates (``prefill_model(rows=)``): fewer live tokens than state rows
pad with empty rows, so every matmul runs at the state's row count and a
row's logits do not depend on which other rows are live.

Training (``forward_train``, ``lm_loss``) runs the same layers in a
``train`` form: no state, nothing written in place, no kernel (K1-K4
have no backward): ``attn_half`` in ``train`` mode
(``attention.attention_train``), the MoE half through ``moe.moe_forward``
(with a capacity and aux losses), a recurrent layer's ``prefill`` with its
state dropped; each layer under the run's remat policy
(``torch.utils.checkpoint``); the loss chunked over the sequence, each
chunk recomputed in the backward, so no [B, S, V] tensor is kept.

The sharded paths (``Runtime.mesh``, a ``DeviceMesh``): each rank holds its
data rank's rows and its shard of every parameter (``shard_params``: each
leaf cut by the rules, ``distributed/sharding.py:make_param_shardings``) and
of the decode state (``shard_state``: KV caches split by sequence over the
tensor axis, ``make_state_shardings``). Over the tensor axis: the
vocabulary-parallel embedding and head (``distributed/parallel.py``);
Megatron-style attention where the heads divide the axis (``wq`` / ``wo``
by query heads, ``wk`` / ``wv`` by KV heads, each only where its count
divides; with whole ``wk`` / ``wv`` a rank uses the KV heads of its own
query groups), K4 on the local heads and one all-reduce after the
row-parallel ``wo``; column- and row-parallel MLPs (one all-reduce); each
MoE layer expert-parallel (``moe.moe_epsum_local``, ``moe_epsum_decode_local``);
for a long prompt whose heads the axis does not divide, the queries split
over the axis (``_sp_attention``). Prefill leaves the KV caches in the
``state_spec`` layout (the K/V gathered over the head split, each rank
keeping its positions); decode scores its slice with every query head
through K2's partial entry and merges the slices' partials after one
all-gather (``_tp_decode``). Rotary residency under the tensor axis
(``shard_residency``: each MoE layer's slot planes split on the expert width
F, the LUT whole) runs decode steps, windows and prefill chunks: the routed
experts through this rank's F slice and one f32 all-reduce
(``moe.moe_apply_routed(tp_group=)``), a chunk's attention against the
rank's cache slice through K4's partial chunk entry and the same merge
(``_tp_chunk``), and a window's KV snapshot and rollback over the rank's own
positions. Rows split over the data axis need no collective. A ring cache, or a recurrent stack's decode, under a tensor
axis longer than 1 raises before anything is built (a recurrent stack's
prefill keeps its caches whole, as the sequence-parallel prefill makes
them).

Training under the mesh (``forward_train`` / ``lm_loss`` with ``rt.mesh``,
driven by ``training/trainer.py``) runs plain, differentiable forms through
the collectives of ``distributed/parallel.py``: attention split by heads, or
by query positions (:func:`_tp_train_attention`), column- / row-parallel
MLPs, expert-parallel MoE with its router losses (``moe.moe_epsum_train``),
the vocabulary-parallel embedding and cross-entropy
(:func:`_vocab_chunk_loss`), and, for FSDP storage, each layer's shards
gathered at use inside its remat'd block.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils import checkpoint as ckpt

from repro_torch.config.base import KV_KINDS, ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import (
    make_param_shardings, make_residency_shardings, make_state_shardings, shard_tensor,
)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import sampling as sampling_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    Params, apply_mlp, apply_norm, embed_init, init_mlp, init_norm,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclass(frozen=True)
class Runtime:
    """Execution context: the KV cache capacity decode runs against; the
    sharding config; the chunk lengths of training attention (queries, keys)
    and of the loss (positions); and ``mesh``, a ``DeviceMesh`` this process
    belongs to (None: one device). Under a mesh ``prefill_model`` and
    ``decode_model`` take the sharded paths, given this rank's rows and
    this rank's parameters (``shard_params``)."""

    cache_len: int = 2048
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    q_chunk: int = 512
    kv_chunk: int = 512
    loss_chunk: int = 512
    mesh: Optional[Any] = None

    def tp_size(self) -> int:
        """The tensor axis' length; a mesh without that axis raises."""
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.sharding.tp_axis not in names:
            raise ValueError(f"the sharded paths split over the tensor axis "
                             f"{self.sharding.tp_axis!r}; the mesh has {names}")
        return int(self.mesh.size(names.index(self.sharding.tp_axis)))

    def tp_rank(self) -> int:
        return self.mesh.get_local_rank(self.sharding.tp_axis)

    def tp_group(self):
        return self.mesh.get_group(self.sharding.tp_axis)

    def ep_axis(self) -> str:
        """The axis an MoE layer's experts are split over under the mesh:
        the tensor axis, with ``moe_impl="epsum"`` (every other dispatch
        needs the whole expert store on each rank)."""
        if self.sharding.moe_impl != "epsum":
            raise ValueError(f"under a mesh the MoE half runs expert parallelism "
                             f"(moe_impl='epsum'), got {self.sharding.moe_impl!r}")
        self.tp_size()
        return self.sharding.tp_axis


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def init_params(cfg: ModelConfig, seed: int, device="cuda", *,
                expert_device=None) -> Params:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``.

    ``expert_device="cpu"`` generates each layer's routed experts on
    ``device`` and moves them to (pinned) host memory at once, so a
    full-width warehouse never sits on the card whole. ``device="meta"``
    gives every leaf's shape and type without memory."""
    device = torch.device(device)
    dtype = torch_dtype(cfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    layers = [_init_block(gen, kind, cfg, dtype, device, expert_device)
              for kind in cfg.layer_kinds]
    p: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "layers": layers,
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    if cfg.frontend is not None and cfg.frontend_dim != cfg.d_model:
        p["frontend_proj"] = embed_init(gen, (cfg.frontend_dim, cfg.d_model), dtype, device)
    return p


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype: torch.dtype, device,
                expert_device) -> Params:
    """One layer's weights, the reference's ``_init_block`` layout."""
    d = cfg.d_model
    if kind in ("mlstm", "slstm"):
        init = xlstm_mod.init_mlstm if kind == "mlstm" else xlstm_mod.init_slstm
        return {"ln": init_norm(cfg.norm, d, dtype, device),
                "cell": init(gen, d, cfg.recurrent, dtype, device)}
    layer = {"ln1": init_norm(cfg.norm, d, dtype, device)}
    if kind == "rglru":
        layer["rec"] = rglru_mod.init_rglru(gen, d, cfg.recurrent, dtype, device)
    else:
        layer["attn"] = attn.init_attention(gen, d, cfg.attention, dtype, device)
    layer["ln2"] = init_norm(cfg.norm, d, dtype, device)
    if kind == "attn_moe":
        layer["moe"] = moe_mod.init_moe(gen, d, cfg.moe, cfg.mlp, dtype, device,
                                        expert_device=expert_device)
    else:
        layer["mlp"] = init_mlp(cfg.mlp, gen, d, cfg.d_ff, dtype, device)
    return layer


def _zero_block_state(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device) -> Dict[str, torch.Tensor]:
    """One layer's decode state: a KV cache, or the recurrent cell's state."""
    if kind in KV_KINDS:
        return attn.zero_cache(cfg.attention, batch, cache_len, torch_dtype(cfg), device)
    zero = {"rglru": rglru_mod.rglru_zero_state, "mlstm": xlstm_mod.mlstm_zero_state,
            "slstm": xlstm_mod.slstm_zero_state}[kind]
    return zero(batch, cfg.d_model, cfg.recurrent, device)


def zero_state(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> List[Dict[str, torch.Tensor]]:
    return [_zero_block_state(cfg, kind, batch, cache_len, device) for kind in cfg.layer_kinds]


def paged_zero_state(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> List[Dict[str, torch.Tensor]]:
    """Decode state over the serving engine's PAGED KV pool (the reference's
    ``paged_zero_state``): per layer ``{"k", "v"}`` planes [num_pages,
    page_size, Hkv, dh] shared by every row and addressed through per-row
    page tables (``attention_decode(page_table=...)``). ``num_pages`` counts
    the scratch page the pool keeps at index 0. KV-only stacks: a recurrent
    state is per row by construction and cannot be paged."""
    for kind in cfg.layer_kinds:
        if kind not in KV_KINDS:
            raise ValueError(f"paged KV pool requires KV-cache blocks, got {kind!r}")
    a = cfg.attention
    shape = (num_pages, page_size, a.num_kv_heads, a.head_dim)
    dtype = torch_dtype(cfg)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _tensor_axis(rt: Optional[Runtime]) -> bool:
    """Whether ``rt`` has a mesh with a tensor axis longer than 1."""
    return (rt is not None and rt.mesh is not None
            and rt.sharding.tp_axis in (rt.mesh.mesh_dim_names or ()) and rt.tp_size() > 1)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           rt: Optional[Runtime]) -> torch.Tensor:
    """``embed_tokens``, vocabulary-parallel where ``embed`` holds this
    rank's rows only."""
    if _tensor_axis(rt) and params["embed"].shape[0] < cfg.vocab_size:
        return parallel.vocab_embed(params["embed"], tokens, rt.tp_rank(), rt.tp_group())
    return embed_tokens(params, tokens)


def prepend_frontend(cfg: ModelConfig, params: Params, x: torch.Tensor,
                     frontend: Optional[torch.Tensor]) -> torch.Tensor:
    """The frontend's precomputed embeddings [B, F, frontend_dim] (cast to
    x's type, projected when ``frontend_proj`` exists) before the prompt's
    [B, S, D]; x unchanged for an arch without a frontend, which raises when
    ``frontend`` is missing (the reference asserts)."""
    if cfg.frontend is None:
        return x
    if frontend is None:
        raise ValueError(f"{cfg.name} requires frontend embeddings (frontend=)")
    fe = frontend.to(device=x.device, dtype=x.dtype)
    if "frontend_proj" in params:
        fe = fe @ params["frontend_proj"]
    return torch.cat([fe, x], dim=1)


def moe_ordinals(params: Params) -> List[Optional[int]]:
    """Per layer, its ordinal among the MoE layers, or None for a dense one."""
    out: List[Optional[int]] = []
    n = 0
    for p in params["layers"]:
        out.append(n if "moe" in p else None)
        n += "moe" in p
    return out


def lm_logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
              rt: Optional[Runtime] = None) -> torch.Tensor:
    """The final norm and the head: logits [..., V]. A head holding this
    rank's vocabulary columns only (``rt``'s tensor axis) gives its local
    logits, all-gathered in rank order."""
    h = apply_norm(cfg.norm, params["final_norm"], h)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head
    if _tensor_axis(rt) and head.shape[1] < cfg.vocab_size:
        return parallel.gather_vocab(logits, rt.tp_group(), rt.tp_size())
    return logits


def attn_half(cfg: ModelConfig, p: Params, x: torch.Tensor, mode: str, state: Any = None,
              cur_len: Union[int, torch.Tensor] = 0, cache_len: int = 0,
              page_table: Optional[torch.Tensor] = None,
              rt: Optional[Runtime] = None) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Attention + residual, then the FFN's input norm: (x_mid, h2 [T, D], state).
    ``prefill`` rewrites ``state`` in place (a fresh cache when it is None);
    ``decode`` updates ``state`` in place at ``cur_len`` (an int or a device
    scalar or per-row [B]; with ``page_table``, ``state`` is a layer of the
    paged pool); ``chunk`` appends x's C positions to ``state`` in place at
    ``cur_len``; ``train`` keeps no state (``attention_train`` at ``rt``'s
    chunk lengths, no kernel). Under ``rt.mesh`` a ``prefill`` runs
    :func:`_tp_prefill` (or, long with heads the tensor axis does not
    divide, :func:`_sp_attention`), a ``decode`` :func:`_tp_decode` and a
    ``chunk`` :func:`_tp_chunk`, each on this rank's shards."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    sharded = rt is not None and rt.mesh is not None
    if mode == "train" and _tensor_axis(rt):
        y = _tp_train_attention(cfg, p["attn"], rt, h)
    elif mode == "train":
        rt = rt or Runtime()
        y = attn.attention_train(p["attn"], cfg.attention, h,
                                 q_chunk=rt.q_chunk, kv_chunk=rt.kv_chunk)
    elif mode == "prefill" and _use_sp(cfg, rt, x.shape[1]):
        y, state = _sp_attention(p["attn"], cfg.attention, rt, h, cache_len, state)
    elif mode == "prefill" and sharded:
        y, state = _tp_prefill(p["attn"], cfg.attention, rt, h, cache_len, state)
    elif mode == "decode" and sharded:
        y = _tp_decode(p["attn"], cfg.attention, rt, h, state, cur_len)
    elif mode == "chunk" and sharded:
        y = _tp_chunk(p["attn"], cfg.attention, rt, h, state, cur_len)
    elif mode == "prefill":
        y, state = attn.attention_prefill(p["attn"], cfg.attention, h, cache_len, state)
    elif mode == "decode":
        y = attn.attention_decode(p["attn"], cfg.attention, h, state, cur_len, page_table)
    elif mode == "chunk":
        y = attn.attention_prefill_chunk(p["attn"], cfg.attention, h, state, cur_len)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x_mid = x + y
    h2 = apply_norm(cfg.norm, p["ln2"], x_mid).reshape(-1, x.shape[-1])
    return x_mid, h2, state


def _use_sp(cfg: ModelConfig, rt: Optional[Runtime], s: int) -> bool:
    """The reference's condition for sequence-parallel prefill attention:
    a mesh, heads that the tensor axis does not divide (no head split),
    and at least 2,048 positions that it does."""
    if rt is None or rt.mesh is None:
        return False
    tp = rt.tp_size()
    return cfg.attention.num_heads % tp != 0 and s % tp == 0 and s >= 2048


def _sp_attention(p: Params, acfg, rt: Runtime, h: torch.Tensor, cache_len: int,
                  cache: Optional[Dict[str, torch.Tensor]]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence-parallel prefill attention (the reference's ``_sp_attention``):
    h [B, S, D], the same on every rank of the tensor axis. Rank r scores
    queries ``[r*S/tp, (r+1)*S/tp)`` against the full K/V through K4's
    chunk-append entry at offset ``r*S/tp`` (causal by position, with the
    window and soft-cap), the slices are all-gathered over the axis, and
    the output projection is computed whole on every rank, and the KV cache
    written in place (:func:`_write_local`: this rank's positions where the
    state splits them, else whole, ring-indexed for a window, as
    ``attention_prefill``'s). Returns (y [B, S, D], cache)."""
    b, s, _ = h.shape
    tp = rt.tp_size()
    r = rt.mesh.get_local_rank(rt.sharding.tp_axis)
    s_loc = s // tp
    q, k, v = attn._project_qkv(p, acfg, h, torch.arange(s, device=h.device)[None, :])
    ctx = ops.flash_attention_chunk(
        q[:, r * s_loc:(r + 1) * s_loc].contiguous(), k, v,
        torch.full((), r * s_loc, dtype=torch.int64, device=h.device),
        window=acfg.window, soft_cap=acfg.logit_soft_cap)
    parts = [torch.empty_like(ctx) for _ in range(tp)]
    dist.all_gather(parts, ctx, group=rt.mesh.get_group(rt.sharding.tp_axis))
    y = torch.cat(parts, dim=1).reshape(b, s, -1) @ p["wo"]
    return y, _write_local(acfg, rt, k, v, cache_len, cache)


def _seq_offset(acfg, rt: Runtime, local_cap: int) -> Optional[int]:
    """The first position of this rank's cache slice where the state splits
    the sequence over the tensor axis (``state_spec``), None where each rank
    holds the whole cache (``rt.cache_len``'s capacity, ``acfg=None`` a
    window-free one)."""
    cap = rt.cache_len if acfg is None else attn.cache_capacity(acfg, rt.cache_len)
    if local_cap == cap:
        return None
    if local_cap * rt.tp_size() != cap:
        raise ValueError(f"a cache slice of {local_cap} positions is neither the whole "
                         f"capacity {cap} (rt.cache_len {rt.cache_len}) nor its 1/{rt.tp_size()}")
    return rt.tp_rank() * local_cap


def _write_local(acfg, rt: Runtime, k: torch.Tensor, v: torch.Tensor, cache_len: int,
                 cache: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """A prefill's whole K/V [B, S, Hkv, dh] into this rank's cache: the
    positions of its slice (zeroed first) where the state splits the
    sequence, else the whole cache (``attention.write_cache``)."""
    off = None if cache is None else _seq_offset(acfg, rt, cache["k"].shape[1])
    if off is None:
        return attn.write_cache(acfg, k, v, cache_len, cache)
    cache["k"].zero_()
    cache["v"].zero_()
    n = max(0, min(k.shape[1], off + cache["k"].shape[1]) - off)
    cache["k"][:, :n] = k[:, off:off + n]
    cache["v"][:, :n] = v[:, off:off + n]
    return cache


def _query_kv(acfg, rt: Runtime, k: torch.Tensor, v: torch.Tensor,
              hq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V heads this rank's ``hq`` query heads read: its own KV heads
    when ``wk`` / ``wv`` are split with the queries (or nothing is split),
    else (whole K/V, split queries) the KV heads of its query groups."""
    g = acfg.num_heads // acfg.num_kv_heads
    if hq == acfg.num_heads or k.shape[2] < acfg.num_kv_heads:
        return k, v
    lo = rt.tp_rank() * hq
    if g % hq == 0:
        sel = slice(lo // g, lo // g + 1)
    elif hq % g == 0:
        sel = slice(lo // g, (lo + hq) // g)
    else:
        raise ValueError(f"{hq} query heads a rank do not tile groups of {g}")
    return k[:, :, sel], v[:, :, sel]


def _tp_prefill(p: Params, acfg, rt: Runtime, h: torch.Tensor, cache_len: int,
                cache: Optional[Dict[str, torch.Tensor]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill attention on this rank's heads (the projections as
    ``shard_params`` cut them; whole where the rules keep them whole): K4
    over the local query heads and the KV heads they read, the
    row-parallel ``wo`` and one all-reduce where ``wo`` is split. The cache
    takes every KV head: the local ones all-gathered over the axis where
    ``wk`` / ``wv`` are split, then this rank's positions kept
    (:func:`_write_local`). Returns (y [B, S, D], cache)."""
    b, s, _ = h.shape
    q, k, v = attn._project_qkv(p, acfg, h, torch.arange(s, device=h.device)[None, :])
    kq, vq = _query_kv(acfg, rt, k, v, q.shape[2])
    ctx = ops.flash_attention(q, kq, vq, causal=True, window=acfg.window,
                              soft_cap=acfg.logit_soft_cap)
    y = ctx.reshape(b, s, -1) @ p["wo"]
    group, tp = rt.tp_group(), rt.tp_size()
    if p["wo"].shape[0] < acfg.num_heads * acfg.head_dim:
        y = parallel.all_reduce_f32(y, group)
    if k.shape[2] < acfg.num_kv_heads:
        k = parallel.all_gather_dim(k, 2, group, tp)
        v = parallel.all_gather_dim(v, 2, group, tp)
    return y, _write_local(acfg, rt, k, v, cache_len, cache)


def _tp_decode(p: Params, acfg, rt: Runtime, h: torch.Tensor, cache: Dict[str, torch.Tensor],
               cur_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """One decode step's attention on this rank's shards, against its cache
    slice (``state_spec``: the sequence split over the tensor axis, rank r
    holding positions ``[r C/tp, (r+1) C/tp)`` of every KV head).

    The new token's K/V is all-gathered over the KV-head split (a few KB)
    and written only by the rank whose slice holds position ``cur_len``; q
    is all-gathered over the head split. Each rank scores every query head
    over its slice at local length ``clamp(cur_len + 1 - r C/tp, 0, C/tp)``
    (K2's partial entry: normalized context and lse; an empty slice gives
    lse ``-inf``), one all-gather of [tp, B, H, dh + 1] follows and each
    rank merges the slices in rank order (``parallel.merge_partials``), so
    the model ranks hold the same bits. A rank then keeps its heads'
    context for the row-parallel ``wo`` (one all-reduce). A state holding
    the whole cache (a capacity the axis does not divide) scores it whole
    with K2's contiguous entry. h [B, 1, D] -> y [B, 1, D]."""
    b = h.shape[0]
    nh, nkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    group, tp, r = rt.tp_group(), rt.tp_size(), rt.tp_rank()
    cl = torch.as_tensor(cur_len, device=h.device).to(torch.int64).reshape(-1).expand(b)
    q, k_new, v_new = attn._project_qkv(p, acfg, h, cl[:, None])
    hq = q.shape[2]
    if k_new.shape[2] < nkv:
        k_new = parallel.all_gather_dim(k_new, 2, group, tp)
        v_new = parallel.all_gather_dim(v_new, 2, group, tp)
    if hq < nh:
        q = parallel.all_gather_dim(q, 2, group, tp)
    ck, cv = cache["k"], cache["v"]
    c_loc = ck.shape[1]
    off = _seq_offset(acfg, rt, c_loc)
    rows = torch.arange(b, device=h.device)
    if off is None:
        slot = torch.remainder(cl, c_loc)
        ck.index_put_((rows, slot), k_new[:, 0])
        cv.index_put_((rows, slot), v_new[:, 0])
        lengths = torch.clamp(cl.to(torch.int32) + 1, max=c_loc)
        ctx = ops.decode_attention(q, ck, cv, lengths=lengths, soft_cap=acfg.logit_soft_cap)
    else:
        local = cl - off
        own = ((local >= 0) & (local < c_loc))[:, None, None]
        slot = torch.clamp(local, 0, c_loc - 1)
        ck.index_put_((rows, slot), torch.where(own, k_new[:, 0], ck[rows, slot]))
        cv.index_put_((rows, slot), torch.where(own, v_new[:, 0], cv[rows, slot]))
        lengths = torch.clamp(cl + 1 - off, 0, c_loc).to(torch.int32)
        part = ops.decode_attention_partial(q[:, 0], ck, cv, lengths=lengths,
                                            soft_cap=acfg.logit_soft_cap)
        parts = parallel.all_gather_dim(part[None], 0, group, tp)
        ctx = parallel.merge_partials(parts, q.dtype)[:, None]
    if hq < nh:
        ctx = ctx[:, :, r * hq:(r + 1) * hq]
    y = ctx.reshape(b, 1, hq * dh) @ p["wo"]
    if p["wo"].shape[0] < nh * dh:
        y = parallel.all_reduce_f32(y, group)
    return y


def _tp_chunk(p: Params, acfg, rt: Runtime, h: torch.Tensor, cache: Dict[str, torch.Tensor],
              cur_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """A prefill chunk's attention on this rank's shards against its cache
    slice (the chunk counterpart of :func:`_tp_decode`): q / k / v for the
    chunk's C positions ``cur_len ..`` on the head split, the new K/V
    all-gathered over the KV-head split and q over the head split; each
    rank writes the chunk's positions that fall in its slice (a chunk may
    straddle two slices: every slot of the slice is rewritten with the
    chunk's K/V where it holds a chunk position, so a device ``cur_len``
    needs no host round trip), then scores every query head over its slice
    through K4's partial chunk entry (normalized context and lse; ``-inf``
    where the slice holds no visible key), one all-gather of [tp, B, C, H,
    dh + 1] and the merge in rank order (``parallel.merge_partials``), so
    the model ranks hold the same bits; the rank keeps its heads' context
    for the row-parallel ``wo`` and one all-reduce. A state holding the
    whole cache scores it with K4's chunk entry. The chunk must not wrap
    the cache (the engine checks it). h [B, C, D] -> y [B, C, D]."""
    b, c, _ = h.shape
    nh, nkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    group, tp, r = rt.tp_group(), rt.tp_size(), rt.tp_rank()
    cl = torch.as_tensor(cur_len, device=h.device).to(torch.int64).reshape(())
    qpos = cl + torch.arange(c, device=h.device)
    q, k_new, v_new = attn._project_qkv(p, acfg, h, qpos[None, :])
    hq = q.shape[2]
    if k_new.shape[2] < nkv:
        k_new = parallel.all_gather_dim(k_new, 2, group, tp)
        v_new = parallel.all_gather_dim(v_new, 2, group, tp)
    if hq < nh:
        q = parallel.all_gather_dim(q, 2, group, tp)
    ck, cv = cache["k"], cache["v"]
    c_loc = ck.shape[1]
    off = _seq_offset(acfg, rt, c_loc)
    if off is None:
        ck.index_copy_(1, qpos, k_new)
        cv.index_copy_(1, qpos, v_new)
        ctx = ops.flash_attention_chunk(q, ck, cv, cl, soft_cap=acfg.logit_soft_cap)
    else:
        rel = off + torch.arange(c_loc, device=h.device) - cl      # each slot's chunk index
        inside = ((rel >= 0) & (rel < c))[None, :, None, None]
        src = torch.clamp(rel, 0, c - 1)
        ck.copy_(torch.where(inside, k_new.index_select(1, src), ck))
        cv.copy_(torch.where(inside, v_new.index_select(1, src), cv))
        part = ops.flash_attention_chunk_partial(q, ck, cv, cl, off,
                                                 soft_cap=acfg.logit_soft_cap)
        parts = parallel.all_gather_dim(part[None], 0, group, tp)
        ctx = parallel.merge_partials(parts, q.dtype)
    if hq < nh:
        ctx = ctx[:, :, r * hq:(r + 1) * hq]
    y = ctx.reshape(b, c, hq * dh) @ p["wo"]
    if p["wo"].shape[0] < nh * dh:
        y = parallel.all_reduce_f32(y, group)
    return y


def _tp_train_attention(cfg: ModelConfig, p: Params, rt: Runtime,
                        h: torch.Tensor) -> torch.Tensor:
    """Training attention over the tensor axis, h [B, S, D] replicated over
    it -> y [B, S, D], plain and differentiable (K4 has no backward), as
    the reference trains (``use_pallas=False``):

    * sequence-parallel where :func:`_use_sp` holds (the reference's
      ``_sp_attention``): q, k and v whole on every rank, rank r attends
      its query chunk ``[r S/tp, (r+1) S/tp)`` over the whole K/V
      (``chunked_attention`` at that offset), the chunks all-gathered
      (``gather_from_tp``) and ``wo`` applied whole;
    * head-parallel where ``wq`` holds this rank's heads (as
      :func:`_tp_prefill`, with ``attention_train``'s dataflow), one f32
      all-reduce after the row-parallel ``wo`` (``reduce_from_tp``);
    * else whole on every rank (``attention_train``).

    ``copy_to_tp`` sums the ranks' partial gradients of h; the replicated
    leaves each rank uses for its share only are :func:`tp_partial_leaves`."""
    acfg = cfg.attention
    b, s, _ = h.shape
    group, tp, r = rt.tp_group(), rt.tp_size(), rt.tp_rank()
    kw = dict(causal=True, window=acfg.window, soft_cap=acfg.logit_soft_cap)
    positions = torch.arange(s, device=h.device)[None, :]
    if _use_sp(cfg, rt, s):
        s_loc = s // tp
        q, k, v = attn._project_qkv(p, acfg, parallel.copy_to_tp(h, group), positions)
        ctx = attn.chunked_attention(q[:, r * s_loc:(r + 1) * s_loc], k, v,
                                     q_chunk=min(rt.q_chunk, s_loc), kv_chunk=rt.kv_chunk,
                                     q_offset=r * s_loc, **kw)
        ctx = parallel.gather_from_tp(ctx, 1, group, tp, r)
        return ctx.reshape(b, s, -1) @ p["wo"]
    if p["wq"].shape[1] == acfg.num_heads * acfg.head_dim:
        return attn.attention_train(p, acfg, h, q_chunk=rt.q_chunk, kv_chunk=rt.kv_chunk)
    q, k, v = attn._project_qkv(p, acfg, parallel.copy_to_tp(h, group), positions)
    k, v = _query_kv(acfg, rt, k, v, q.shape[2])
    if s <= max(rt.q_chunk, 128):
        ctx = attn.reference_attention(q, k, v, **kw)
    else:
        ctx = attn.chunked_attention(q, k, v, q_chunk=rt.q_chunk, kv_chunk=rt.kv_chunk, **kw)
    return parallel.reduce_from_tp(ctx.reshape(b, s, -1) @ p["wo"], group)


def tp_partial_leaves(cfg: ModelConfig, params: Params, rt: Optional[Runtime],
                      seq_len: int) -> List[str]:
    """The paths of the leaves that are whole on every rank of ``rt``'s
    tensor axis but whose gradient a rank's training forward over
    ``seq_len`` positions computes for its share of the work only, so the
    trainer sums it over the axis: under sequence parallelism ``wq``,
    ``wk``, ``wv`` and the qk-norms (each rank scores its queries), under a
    head split the qk-norms and a whole ``wk`` / ``wv`` (each rank reads its
    heads), under expert parallelism the router (each rank combines its
    experts' outputs) and, with shared experts split, their gate. ``wo``
    under SP, whole MLPs, the norms, the embedding and the head take whole
    gradients on every rank (not summed)."""
    if not _tensor_axis(rt):
        return []
    a, out = cfg.attention, []
    for li, (kind, p) in enumerate(zip(cfg.layer_kinds, params["layers"])):
        pre = f"layers/{li}/"
        if kind not in KV_KINDS:
            continue
        names = [n for n in ("wq", "wk", "wv", "q_norm", "k_norm") if n in p["attn"]]
        if _use_sp(cfg, rt, seq_len):
            out += [f"{pre}attn/{n}" for n in names]
        elif p["attn"]["wq"].shape[1] < a.num_heads * a.head_dim:
            out += [f"{pre}attn/{n}" for n in names if n in ("q_norm", "k_norm") or (
                n in ("wk", "wv") and p["attn"][n].shape[1] == a.num_kv_heads * a.head_dim)]
        if "moe" in p and _expert_parallel(cfg, p, rt):
            out.append(f"{pre}moe/router")
            if moe_mod.shared_split(p["moe"], cfg.moe):
                out.append(f"{pre}moe/shared_gate")
    return out


def _expert_parallel(cfg: ModelConfig, p: Params, rt: Optional[Runtime]) -> bool:
    """Whether an MoE layer's routed experts are split over the tensor axis
    (this rank holds E/tp of them); raises unless ``moe_impl`` is epsum."""
    if not _tensor_axis(rt) or p["moe"]["experts"]["w_up"].shape[0] == cfg.moe.storage_experts:
        return False
    rt.ep_axis()
    return True


def mlp_half(cfg: ModelConfig, p: Params, x_mid: torch.Tensor, h2: torch.Tensor,
             rt: Optional[Runtime] = None) -> torch.Tensor:
    """A dense layer's FFN half: x_mid + MLP(h2 [T, D]), in x_mid's shape.
    Column-parallel ``w_gate`` / ``w_up`` and row-parallel ``w_down`` (this
    rank's shards, ``rt``'s tensor axis) give a partial sum, all-reduced in
    f32; differentiable (``copy_to_tp`` in, ``reduce_from_tp`` out)."""
    if not (_tensor_axis(rt) and p["mlp"]["w_down"].shape[0] < cfg.d_ff):
        return x_mid + apply_mlp(cfg.mlp, p["mlp"], h2).reshape(x_mid.shape)
    group = rt.tp_group()
    y = parallel.reduce_from_tp(apply_mlp(cfg.mlp, p["mlp"], parallel.copy_to_tp(h2, group)),
                                group)
    return x_mid + y.reshape(x_mid.shape)


def recurrent_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, mode: str,
                    state: Optional[Dict[str, torch.Tensor]]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A recurrent layer (``rglru``, ``mlstm``, ``slstm``; the reference's
    ``_apply_block``) over x [B, S, D]: ``prefill`` from the zero state, or
    one ``decode`` step from ``state``. Returns (x out, the new state); the
    caller stores the state. Training runs ``prefill`` and drops the state
    (the reference's ``rglru_train``, ``mlstm_train``, ``slstm_train``).
    A chunk raises, as in the reference: a recurrent update consumes its
    state one position a call."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"chunked prefill requires KV-cache blocks, got {kind!r}")
    decode = mode == "decode"
    if kind == "rglru":
        h = apply_norm(cfg.norm, p["ln1"], x)
        y, new = (rglru_mod.rglru_decode(p["rec"], h, state) if decode
                  else rglru_mod.rglru_prefill(p["rec"], h, cfg.recurrent))
        x = x + y
        return x + apply_mlp(cfg.mlp, p["mlp"], apply_norm(cfg.norm, p["ln2"], x)), new
    h = apply_norm(cfg.norm, p["ln"], x)
    if kind == "mlstm":
        y, new = (xlstm_mod.mlstm_decode(p["cell"], h, state) if decode
                  else xlstm_mod.mlstm_prefill(p["cell"], h, cfg.recurrent))
    else:
        y, new = (xlstm_mod.slstm_decode(p["cell"], h, state) if decode
                  else xlstm_mod.slstm_prefill(p["cell"], h, cfg.recurrent))
    return x + y, new


def _store(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    """A recurrent state written into its tensors in place."""
    for n, t in src.items():
        dst[n].copy_(t)


def decode_model(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,              # [B] current token
    state: List[Dict[str, torch.Tensor]],
    cur_len: Union[int, torch.Tensor],  # tokens already in the cache (int, device scalar or [B])
    residency: Optional[List[Tuple[Params, torch.Tensor]]] = None,
    page_table: Optional[torch.Tensor] = None,
    rt: Optional[Runtime] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over every layer: returns (logits [B, V], aux).
    Under ``rt.mesh`` (this rank's rows, parameters and state slice): each
    attention layer :func:`_tp_decode`, each dense MLP tensor-parallel, each
    MoE layer expert-parallel decode (``moe.moe_epsum_decode_local``: local
    experts, one all-reduce) or, with ``residency`` (``shard_residency``:
    this rank's F slice of every slot), the slots' partial sums and one f32
    all-reduce; the embedding and head vocabulary-parallel (logits
    all-gathered).
    ``page_table`` [B, pages]: ``state`` is the serving engine's paged pool
    (:func:`paged_zero_state`) instead of per-row caches.

    ``residency`` gives each layer's (slot buffers, device LUT); None reads
    the full expert store in ``params``. ``state`` is updated in place. With
    a device ``cur_len`` the step makes no host round trip, so a CUDA graph
    can capture it. aux
    holds the routing telemetry stacked over the MoE layers: ``route_ids`` /
    ``route_weights`` / ``route_miss`` [L, T, k], ``route_h`` [L, T, D] (the
    MoE inputs the demand GEMM reads) and ``route_x`` [L, T, D] (each block's
    input, the replay anchor); empty for a dense stack. ``residency`` has
    one entry per MoE layer.

    A contiguous ``state`` fixes the row count: with fewer tokens than its
    rows the batch pads with empty rows (token 0, a per-row ``cur_len``
    with 0) and only the given rows' logits return (aux covers every
    row), so each matmul runs at the state's row count, whatever rows are
    live."""
    if rt is not None and rt.mesh is not None:
        _check_mesh_stack(cfg, rt, rt.cache_len, decode=True)
    b = token.shape[0]
    rows = b if page_table is not None else next(iter(state[0].values())).shape[0]
    if rows > b:
        token = torch.cat([token, token.new_zeros(rows - b)])
        if isinstance(cur_len, torch.Tensor) and cur_len.numel() > 1:
            cur_len = torch.cat([cur_len, cur_len.new_zeros(rows - b)])
    x = _embed(cfg, params, token[:, None], rt)
    x, aux = _run_stack(cfg, params, x, "decode", state, cur_len, residency, page_table, rt)
    return lm_logits(cfg, params, x[:b, -1:], rt)[:, 0], aux


def prefill_model(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # [B, S] right-padded prompts
    cache_len: int,
    *,
    last_index: Optional[torch.Tensor] = None,
    residency: Optional[List[Tuple[Params, torch.Tensor]]] = None,
    correct: Optional[Callable[..., torch.Tensor]] = None,
    experts: Optional[Callable[[int], Params]] = None,
    frontend: Optional[torch.Tensor] = None,
    rows: Optional[int] = None,
    moe_capacity: Optional[int] = None,
    rt: Optional[Runtime] = None,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """The serving engine's admission prefill (the reference's
    ``prefill_model`` under its scan over rows): returns (logits [B, V] at
    each row's ``last_index`` [B] (default: the last position), a fresh
    contiguous state per layer, [B, cache_len] caches or [B, ...] recurrent
    states). Each row runs as a batch-1 prefill of its EXACT length,
    ``last_index + 1`` positions, layer by layer, its logits through the
    head alone: a row's bits depend neither on the pads of the bucket nor
    on the other rows, and a pad never reaches a recurrent state (the
    reference prefills its recurrent archs at exact lengths too). A
    row's cache slots past its length stay zero; decode never reads them
    before writing them.

    The reference reads every routed expert from ``params``. Here each
    layer's MoE half reads the layer's expert store (``experts(li)`` when
    given, called once per layer before its rows: the serving engine's
    float store staged on the device under quantized slots), or, with
    ``residency``, each layer's (slot buffers, LUT) serves the resident
    picks and ``correct(li, row, x, h2, ids, weights, miss)`` returns x
    with the missed picks added (the engine's host GEMM). Nothing here
    resolves, rotates or records: the residency a caller holds is left as
    it was. ``li`` in the callbacks and ``residency`` count MoE layers; an
    ``attn_mlp`` or ``local_attn`` layer runs its dense MLP, a recurrent
    layer its cell.

    ``frontend`` [B, F, frontend_dim]: a frontend arch's embeddings, which
    take positions 0 .. F - 1 of every row before its tokens (``last_index``
    then counts them too); such an arch raises without them.

    ``rows``: the state's row count (default B; rows past B stay empty), so
    an eager ``decode_model`` after it runs at that count (a lone row inside
    the batch's allocation). ``moe_capacity``: each MoE layer keeps at most
    that many of a row's assignments per expert, in token order, and drops
    the rest (their gate weight zeroed), as the reference's sorted dispatch
    does over a batch-1 bucket whose capacity this is
    (``moe.capacity(mcfg, bucket)``: the bucket's pads sort after the row's
    tokens, so only the capacity carries the bucket); None is dropless.

    ``rt`` with a mesh: the sharded prefill (:func:`_prefill_sharded`)."""
    if rt is not None and rt.mesh is not None:
        if any(a is not None for a in (residency, correct, experts, moe_capacity)):
            raise ValueError("the sharded prefill takes no residency, correction, expert "
                             "store or capacity: it runs the reference's epsum dispatch")
        return _prefill_sharded(cfg, params, tokens, cache_len, rt, last_index, frontend, rows)
    b = tokens.shape[0]
    n_front = cfg.frontend_len if cfg.frontend is not None else 0
    last = ([tokens.shape[1] + n_front - 1] * b if last_index is None
            else [int(v) for v in last_index.reshape(-1).tolist()])
    state = zero_state(cfg, rows or b, cache_len, tokens.device)
    xs = [prepend_frontend(cfg, params, embed_tokens(params, tokens[i:i + 1, :j + 1 - n_front]),
                           None if frontend is None else frontend[i:i + 1])
          for i, j in enumerate(last)]
    for li, (kind, p, mi) in enumerate(zip(cfg.layer_kinds, params["layers"],
                                           moe_ordinals(params))):
        if mi is not None:
            moe_p = p["moe"] if experts is None else {**p["moe"], "experts": experts(mi)}
            slots, lut = residency[mi] if residency is not None else (None, None)
        for i in range(b):
            row = {n: t[i:i + 1] for n, t in state[li].items()}
            if kind not in KV_KINDS:
                xs[i], new = recurrent_block(cfg, kind, p, xs[i], "prefill", None)
                _store(row, new)
                continue
            x_mid, h2, _ = attn_half(cfg, p, xs[i], "prefill", row, 0, cache_len)
            if mi is None:
                xs[i] = mlp_half(cfg, p, x_mid, h2)
                continue
            ids, weights = moe_mod.route(moe_p, h2, cfg.moe)
            if moe_capacity is not None:
                weights = weights * moe_mod.capacity_keep(ids.long(), moe_capacity)
            y2, miss = moe_mod.moe_apply_routed(moe_p, h2, ids, weights,
                                                slot_buffer=slots, lut=lut)
            xs[i] = x_mid + y2.reshape(x_mid.shape)
            if correct is not None:
                xs[i] = correct(mi, i, xs[i], h2, ids, weights, miss)
    logits = torch.cat([lm_logits(cfg, params, x[:, -1:])[:, 0] for x in xs])
    return logits, state


def _prefill_sharded(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache_len: int,
                     rt: Runtime, last_index: Optional[torch.Tensor],
                     frontend: Optional[torch.Tensor], rows: Optional[int]
                     ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """The reference's ``prefill_model`` under a mesh, on this rank's rows
    (``tokens`` [B, S], the same on every rank of the tensor axis; rows on
    other data ranks need no collective) and this rank's parameters
    (:func:`shard_params`). The whole batch goes through each layer at
    once, as in the reference: attention on this rank's heads
    (:func:`_tp_prefill`), or split over the tensor axis by query positions
    where :func:`_use_sp` holds; each dense MLP tensor-parallel; each MoE
    layer expert-parallel over the B*S tokens at the reference's capacity
    (``moe.moe_forward(impl="epsum")``, so pads count as tokens, as they do
    there); a recurrent layer's cell over the batch. Returns (logits [B, V]
    at ``last_index`` (default the last position), the state: this rank's
    slice of each KV cache (:func:`_sharded_zero_state`))."""
    _check_mesh_stack(cfg, rt, cache_len)
    b = tokens.shape[0]
    x = prepend_frontend(cfg, params, _embed(cfg, params, tokens, rt), frontend)
    state = _sharded_zero_state(cfg, rows or b, cache_len, rt, tokens.device)
    for li, (kind, p) in enumerate(zip(cfg.layer_kinds, params["layers"])):
        layer = {n: t[:b] for n, t in state[li].items()}
        if kind not in KV_KINDS:
            x, new = recurrent_block(cfg, kind, p, x, "prefill", None)
            _store(layer, new)
            continue
        x_mid, h2, _ = attn_half(cfg, p, x, "prefill", layer, 0, cache_len, rt=rt)
        if "moe" not in p:
            x = mlp_half(cfg, p, x_mid, h2, rt)
            continue
        y2, _ = moe_mod.moe_forward(p["moe"], cfg.moe, h2.reshape(x_mid.shape), "epsum",
                                    mesh=rt.mesh, ep_axis=rt.ep_axis())
        x = x_mid + y2
    last = x[:, -1] if last_index is None else x[torch.arange(b, device=x.device),
                                                    last_index.reshape(-1).long()]
    return lm_logits(cfg, params, last[:, None], rt)[:, 0], state


def _check_mesh_stack(cfg: ModelConfig, rt: Runtime, cache_len: int, *,
                     decode: bool = False) -> None:
    """Raise, before anything is built, for what the sharded serving paths
    do not run under a tensor axis longer than 1: a recurrent stack's
    decode (the rules split a recurrent layer's width: a later slice) and a
    ring cache (a window shorter than ``cache_len``) in a KV-only stack."""
    if not _tensor_axis(rt):
        return
    if decode and any(kind not in KV_KINDS for kind in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: a recurrent stack's decode under a tensor axis of "
                         f"{rt.tp_size()} is not ported (the width split of its layers)")
    if cfg.attention is not None and all(kind in KV_KINDS for kind in cfg.layer_kinds):
        cap = attn.cache_capacity(cfg.attention, cache_len)
        if cap < cache_len:
            raise ValueError(f"{cfg.name}: a ring cache (window {cfg.attention.window} < "
                             f"cache_len {cache_len}) under a tensor axis of {rt.tp_size()} "
                             f"is not ported")


def _sharded_zero_state(cfg: ModelConfig, rows: int, cache_len: int, rt: Optional[Runtime],
                       device) -> List[Dict[str, torch.Tensor]]:
    """:func:`zero_state` for ``rows`` local rows, each KV cache cut to this
    rank's slice of the sequence where ``state_spec`` splits it over the
    tensor axis (a KV-only stack and a capacity the axis divides; else
    whole on each rank)."""
    a = cfg.attention
    kv_only = a is not None and all(kind in KV_KINDS for kind in cfg.layer_kinds)
    cap = attn.cache_capacity(a, cache_len) if a is not None else 0
    if not (_tensor_axis(rt) and kv_only and cap % rt.tp_size() == 0):
        return zero_state(cfg, rows, cache_len, device)
    shape = (rows, cap // rt.tp_size(), a.num_kv_heads, a.head_dim)
    return [{"k": torch.zeros(shape, dtype=torch_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=device)}
            for _ in cfg.layer_kinds]


def shard_params(cfg: ModelConfig, params: Params, rt: Runtime, *,
                 fsdp: bool = False) -> Params:
    """This rank's parameters for the sharded forward: every leaf cut by
    the rules (``make_param_shardings``, sanitized, the sizes the mesh's):
    routed experts on E, attention by heads where the head counts divide the
    tensor axis, MLPs and shared experts column / row parallel, ``embed``
    and ``lm_head`` by vocabulary; with ``fsdp`` (training's storage) also
    over the data axes where ``param_spec(fsdp=True)`` puts them. A cut leaf
    is a copy (the whole one can be freed), a whole one shared with
    ``params``. A recurrent layer the rules would cut over the tensor axis
    raises (its width split is not ported)."""
    specs = make_param_shardings(cfg, rt.mesh, rt.sharding, params, fsdp=fsdp)
    kinds = {f"layers/{i}/": kind for i, kind in enumerate(cfg.layer_kinds)}
    tp = rt.sharding.tp_axis
    for path, spec in specs.items():
        kind = next((k for pre, k in kinds.items() if path.startswith(pre)), None)
        if kind is not None and kind not in KV_KINDS and any(
                e == tp or (isinstance(e, tuple) and tp in e) for e in spec):
            raise ValueError(f"{cfg.name}: {path} would be cut to {spec}; the width split of "
                             f"a recurrent layer is not ported")

    def cut(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: cut(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [cut(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return shard_tensor(tree, specs[prefix[:-1]], rt.mesh)

    return cut(params)


def shard_residency(cfg: ModelConfig, residency: List[Tuple[Params, torch.Tensor]],
                    rt: Runtime) -> List[Tuple[Params, torch.Tensor]]:
    """This rank's residency under ``rt``'s tensor axis: each MoE layer's
    (slot planes, LUT) with the planes cut on the expert width F by
    ``residency_spec`` (copies) and the LUT whole (shared), the layout the
    engine's sliced stores hold. F that the axis does not divide raises."""
    specs = make_residency_shardings(cfg, rt.mesh, rt.sharding, residency)
    return [({n: shard_tensor(t, spec[n], rt.mesh) for n, t in planes.items()}, lut)
            for (planes, lut), spec in zip(residency, specs)]


def shard_state(cfg: ModelConfig, state: List[Dict[str, torch.Tensor]],
                rt: Runtime) -> List[Dict[str, torch.Tensor]]:
    """This rank's shard of a whole decode state (every row, every
    position) by the rules (``make_state_shardings``: rows over the data
    axes where they divide the batch, each KV cache's sequence over the
    tensor axis where it divides the capacity): the layout the sharded
    prefill leaves. A recurrent stack under a tensor axis longer than 1
    raises (the rules split its width)."""
    if _tensor_axis(rt) and any(kind not in KV_KINDS for kind in cfg.layer_kinds):
        raise ValueError(f"{cfg.name}: a recurrent state under a tensor axis of "
                         f"{rt.tp_size()} is not ported (the rules split its width)")
    rows = next(iter(state[0].values())).shape[0]
    cell = ShapeConfig(name="decode", seq_len=rt.cache_len, global_batch=rows, kind="decode")
    specs = make_state_shardings(cfg, rt.mesh, rt.sharding, state, cell)
    return [{n: shard_tensor(t, specs[f"{li}/{n}"], rt.mesh) for n, t in layer.items()}
            for li, layer in enumerate(state)]


def prefill_chunk_model(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # [B, C] the chunk's tokens
    state: List[Dict[str, torch.Tensor]],
    cur_len: Union[int, torch.Tensor],  # tokens already cached (int or device scalar)
    residency: Optional[List[Tuple[Params, torch.Tensor]]] = None,
    with_head: bool = True,
    rt: Optional[Runtime] = None,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """One prefill chunk: append C prompt positions to the caches (in place)
    through every layer in ``chunk`` mode, the multi-token sibling of
    :func:`decode_model`; the MoE half routes all B*C chunk tokens (K3's
    fused entry) and, past ``moe.PER_PICK_MAX`` picks, runs K1's ragged
    entry. Returns (logits [B, V] at the chunk's last position, or None with
    ``with_head=False``, and aux), aux as :func:`decode_model`'s with T =
    B*C. Under ``rt.mesh`` (this rank's parameters, cache slices and
    residency, as :func:`decode_model`): each attention layer
    :func:`_tp_chunk`."""
    if rt is not None and rt.mesh is not None:
        _check_mesh_stack(cfg, rt, rt.cache_len, decode=True)
    x = _embed(cfg, params, tokens, rt)
    x, aux = _run_stack(cfg, params, x, "chunk", state, cur_len, residency, rt=rt)
    if not with_head:
        return None, aux
    return lm_logits(cfg, params, x[:, -1:], rt)[:, 0], aux


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, mode: str,
               state: List[Dict[str, torch.Tensor]], cur_len: Union[int, torch.Tensor],
               residency: Optional[List[Tuple[Params, torch.Tensor]]],
               page_table: Optional[torch.Tensor] = None,
               rt: Optional[Runtime] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every layer in ``mode`` (``decode`` or ``chunk``): attention, then
    the dense MLP, or routing and the routed experts through the MoE
    layer's residency; a recurrent layer's cell, its state written in
    place. Returns the last hidden [B, S, D] and the routing telemetry
    stacked over the MoE layers (none for a stack without MoE layers).
    ``page_table`` (decode): ``state`` is the paged pool. ``rt.mesh``: the
    MoE half is expert-parallel, or with ``residency`` runs this rank's F
    slice of the slots and one all-reduce over the tensor axis."""
    d = x.shape[-1]
    ep_axis = group = None
    if rt is not None and rt.mesh is not None:
        if mode not in ("decode", "chunk"):
            raise ValueError("under a mesh the stack runs decode steps and prefill chunks")
        if residency is not None:
            group = rt.tp_group() if _tensor_axis(rt) else None
        elif cfg.has_moe:
            ep_axis = rt.ep_axis()
    tel: Dict[str, List[torch.Tensor]] = {n: [] for n in ("ids", "weights", "miss", "h", "x")}
    for li, (kind, p, mi) in enumerate(zip(cfg.layer_kinds, params["layers"],
                                           moe_ordinals(params))):
        if kind not in KV_KINDS:
            x, new = recurrent_block(cfg, kind, p, x, mode, state[li])
            _store(state[li], new)
            continue
        x_in = x
        x_mid, h2, _ = attn_half(cfg, p, x, mode, state[li], cur_len, 0, page_table, rt)
        if mi is None:
            x = mlp_half(cfg, p, x_mid, h2, rt)
            continue
        ids, weights = moe_mod.route(p["moe"], h2, cfg.moe)
        if ep_axis is not None:
            y2 = moe_mod.moe_epsum_decode_local(p["moe"], cfg.moe, h2, ids, weights,
                                                mesh=rt.mesh, ep_axis=ep_axis)
            miss = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        else:
            slots, lut = residency[mi] if residency is not None else (None, None)
            y2, miss = moe_mod.moe_apply_routed(p["moe"], h2, ids, weights,
                                                slot_buffer=slots, lut=lut, tp_group=group,
                                                mcfg=cfg.moe)
        x = x_mid + y2.reshape(x_mid.shape)
        for n, v in (("ids", ids), ("weights", weights), ("miss", miss), ("h", h2),
                     ("x", x_in.reshape(-1, d))):
            tel[n].append(v)
    if not tel["ids"]:
        return x, {}
    return x, {f"route_{n}": torch.stack(v) for n, v in tel.items()}


def decode_window(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,              # [B] first token of the window
    state: List[Dict[str, torch.Tensor]],
    cur_len: Union[int, torch.Tensor],  # tokens already in the cache (int or device scalar)
    k_steps: int,
    residency: Optional[List[Tuple[Params, torch.Tensor]]] = None,
    aux_fn: Optional[Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
    sample: Optional[sampling_mod.SampleParams] = None,
    rng_keys: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    rt: Optional[Runtime] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """``k_steps`` self-drafted decode steps (the speculative window; the
    reference's ``decode_window``).

    Position ``j`` runs :func:`decode_model` at ``cur_len + j`` (a device
    scalar stays on the device, so a CUDA graph can capture the window) and
    drafts the next position's token by argmax on the device, or with
    ``sample`` (and ``rng_keys`` [B, 2], the per-row base keys) by a draw
    from the warped distribution keyed by ``fold_in(row_key, cur_len + j)``
    (``sampling.sample_step``); every position gathers from the same
    ``residency`` and writes its KV slot in place. The serving engine passes
    its paged pool as ``state`` with ``page_table`` [B, pages] and a per-row
    ``cur_len`` [B]; each row draws at its own positions. ``rt`` (a mesh):
    each position is :func:`decode_model`'s sharded step.
    Returns ``(draft [K, B], logits [K, B, V] f32, aux)``: ``draft[j]`` is
    the argmax of ``logits[j]`` (the token position j+1 consumed),
    ``logits[-1]`` is the reference's ``last_logits``, and every aux entry
    (after ``aux_fn``, applied per position) is stacked with a leading window
    axis: ``route_ids`` [K, L, T, k], ``route_x`` [K, L, T, D], ..., and when
    sampling ``sample_probs`` [K, B, V] (the warped distributions, draft and
    verifier of a self-drafting window) and ``sample_p`` [K, B] (the drawn
    token's probability)."""
    tok = token
    drafts: List[torch.Tensor] = []
    logits_all: List[torch.Tensor] = []
    auxs: List[Dict[str, torch.Tensor]] = []
    for j in range(k_steps):
        logits, aux = decode_model(cfg, params, tok, state, cur_len + j, residency, page_table,
                                   rt)
        if aux_fn is not None:
            aux = aux_fn(aux)
        if sample is None:
            tok = torch.argmax(logits, dim=-1)      # lowest index on ties, as jnp / np
        else:
            tok, probs, p_tok = sampling_mod.sample_step(logits, rng_keys, cur_len + j, sample)
            aux = {**aux, "sample_probs": probs, "sample_p": p_tok}
        drafts.append(tok)
        logits_all.append(logits.float())
        auxs.append(aux)
    stacked = {n: torch.stack([a[n] for a in auxs]) for n in auxs[0]}
    return torch.stack(drafts), torch.stack(logits_all), stacked


# ---------------------------------------------------------------------------
# KV window snapshot / rollback (speculative decode truncation)
# ---------------------------------------------------------------------------
def _kv_window_slots(cache: torch.Tensor, cur_len: Union[int, torch.Tensor],
                     k_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row / slot index tensors [B, 1], [B, K] of the ``k_steps`` cache slots
    a window starting at ``cur_len`` (scalar or per-row [B]) writes, ring
    slots ``(cur_len + j) % cap``. cache [B, cap, Hkv, dh]."""
    b, cap = cache.shape[0], cache.shape[1]
    if k_steps > cap:
        raise ValueError(f"speculative window ({k_steps}) exceeds KV capacity ({cap})")
    cl = torch.as_tensor(cur_len, device=cache.device).to(torch.int64).reshape(-1).expand(b)
    offs = torch.arange(k_steps, device=cache.device)
    return torch.arange(b, device=cache.device)[:, None], (cl[:, None] + offs[None, :]) % cap


def _kv_window_slots_paged(cache: torch.Tensor, page_table: torch.Tensor,
                           cur_len: Union[int, torch.Tensor],
                           k_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane (page, offset) index tensors [B, K] of the ``k_steps`` logical
    slots ``(cur_len + j) % cap`` a window writes through ``page_table``
    [B, cap // ps] (the reference's ``_kv_window_slots_paged``). cache
    [P, ps, Hkv, dh]."""
    ps = cache.shape[1]
    b, cap = page_table.shape[0], page_table.shape[1] * ps
    if k_steps > cap:
        raise ValueError(f"speculative window ({k_steps}) exceeds KV capacity ({cap})")
    cl = torch.as_tensor(cur_len, device=cache.device).to(torch.int64).reshape(-1).expand(b)
    slots = (cl[:, None] + torch.arange(k_steps, device=cache.device)[None, :]) % cap
    pages = torch.gather(page_table.long(), 1, torch.div(slots, ps, rounding_mode="floor"))
    return pages, slots % ps


def _window_index(cache: torch.Tensor, cur_len: Union[int, torch.Tensor], k_steps: int,
                  page_table: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if page_table is None:
        return _kv_window_slots(cache, cur_len, k_steps)
    return _kv_window_slots_paged(cache, page_table, cur_len, k_steps)


def _slice_offset(rt: Optional[Runtime], cache: torch.Tensor) -> Optional[int]:
    """:func:`_seq_offset` of a window-free ``cache`` [B, n, ...] (rings stay
    whole: they are refused under a tensor axis), None without one."""
    return _seq_offset(None, rt, cache.shape[1]) if _tensor_axis(rt) else None


def _kv_window_local(cache: torch.Tensor, cur_len: Union[int, torch.Tensor], k_steps: int,
                     off: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row / slot index tensors [B, 1], [B, K] of a window's positions in a
    cache slice holding positions ``off ..``: a position outside the slice
    reads a clamped slot (its copy is never restored)."""
    b, n = cache.shape[0], cache.shape[1]
    cl = torch.as_tensor(cur_len, device=cache.device).to(torch.int64).reshape(-1).expand(b)
    local = cl[:, None] + torch.arange(k_steps, device=cache.device)[None, :] - off
    return torch.arange(b, device=cache.device)[:, None], torch.clamp(local, 0, n - 1)


def snapshot_kv_window(state: List[Dict[str, torch.Tensor]],
                       cur_len: Union[int, torch.Tensor],
                       k_steps: int,
                       page_table: Optional[torch.Tensor] = None,
                       rt: Optional[Runtime] = None) -> List[Dict[str, torch.Tensor]]:
    """Pre-window copies of the KV slots the next ``k_steps`` positions
    overwrite, per layer ``{"k", "v"}`` [B, K, Hkv, dh]: what
    :func:`rollback_kv_window` restores (zeros for a full cache, the previous
    lap's entries for a ring cache). ``page_table`` [B, pages]: ``state`` is
    the paged pool, read through each row's pages. ``rt`` with caches split
    by sequence over its tensor axis: each rank copies the window positions
    its slice holds (the others' entries are clamped reads, never
    restored). A recurrent layer's entry is empty (nothing of it can be
    rolled back)."""
    out: List[Dict[str, torch.Tensor]] = []
    for cache in state:
        if "k" not in cache:
            out.append({})
            continue
        off = None if page_table is not None else _slice_offset(rt, cache["k"])
        if off is None:
            rows, slots = _window_index(cache["k"], cur_len, k_steps, page_table)
        else:
            rows, slots = _kv_window_local(cache["k"], cur_len, k_steps, off)
        out.append({n: cache[n][rows, slots] for n in ("k", "v")})
    return out


def rollback_kv_window(state: List[Dict[str, torch.Tensor]],
                       saved: List[Dict[str, torch.Tensor]],
                       cur_len: Union[int, torch.Tensor], k_steps: int,
                       keep: Union[int, torch.Tensor],
                       page_table: Optional[torch.Tensor] = None,
                       rt: Optional[Runtime] = None) -> List[Dict[str, torch.Tensor]]:
    """KV truncate after a partly rejected window, IN PLACE: the slots of
    window offsets ``>= keep`` (scalar or per-row [B]) get their ``saved``
    pre-window contents back, offsets ``< keep`` (the accepted prefix) stay.
    The cache then equals the one a sequential decode holds at length
    ``cur_len + keep``. ``page_table`` [B, pages]: the paged pool, written
    through each row's pages (pad rows' duplicate writes land in the scratch
    page). ``rt`` with caches split by sequence: each rank restores the
    positions its slice holds (every slot of the slice rewritten, its window
    offset read from the slot, so no two writes meet). Returns ``state``."""
    for cache, sv in zip(state, saved):
        if not sv:
            continue
        off = None if page_table is not None else _slice_offset(rt, cache["k"])
        if off is not None:
            _rollback_slice(cache, sv, cur_len, k_steps, keep, off)
            continue
        rows, slots = _window_index(cache["k"], cur_len, k_steps, page_table)
        b = slots.shape[0]
        kp = torch.as_tensor(keep, device=slots.device).to(torch.int64).reshape(-1).expand(b)
        mask = (torch.arange(k_steps, device=slots.device)[None, :] >= kp[:, None])[..., None, None]
        for n in ("k", "v"):
            c = cache[n]
            c[rows, slots] = torch.where(mask, sv[n], c[rows, slots])
    return state


def _rollback_slice(cache: Dict[str, torch.Tensor], sv: Dict[str, torch.Tensor],
                    cur_len: Union[int, torch.Tensor], k_steps: int,
                    keep: Union[int, torch.Tensor], off: int) -> None:
    """:func:`rollback_kv_window` on a cache slice holding positions ``off
    ..``: slot j holds window offset ``off + j - cur_len``; where that offset
    is in ``[keep, k_steps)`` the slot takes its saved copy back."""
    b, n = cache["k"].shape[0], cache["k"].shape[1]
    dev = cache["k"].device
    cl = torch.as_tensor(cur_len, device=dev).to(torch.int64).reshape(-1).expand(b)
    kp = torch.as_tensor(keep, device=dev).to(torch.int64).reshape(-1).expand(b)
    w = off + torch.arange(n, device=dev)[None, :] - cl[:, None]          # [B, n]
    restore = ((w >= kp[:, None]) & (w < k_steps))[..., None, None]
    rows = torch.arange(b, device=dev)[:, None]
    src = torch.clamp(w, 0, k_steps - 1)
    for name in ("k", "v"):
        c = cache[name]
        c.copy_(torch.where(restore, sv[name][rows, src], c))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective checkpointing: keep matmul outputs, recompute the rest
    (the reference's ``jax.checkpoint_policies.dots_saveable``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the remat policy: ``none``, ``full`` (only the inputs
    kept) or ``dots_saveable``; non-reentrant ``torch.utils.checkpoint``."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots_saveable":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                         _dots_saveable))
    raise ValueError(f"unknown remat policy {policy!r}")


def _train_block(cfg: ModelConfig, rt: Runtime, kind: str, p: Params,
                 routing: Optional[moe_mod.Routing], gather: Optional[Callable[[Params], Params]],
                 x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer's train form (the reference's ``_apply_block`` in mode
    ``train``): x [B, S, D] -> (x out, aux: the MoE layer's losses). The
    blocks the engines run, with ``train`` attention, a recurrent cell's
    prefill without its state, and the MoE half through ``moe_forward``, or
    expert-parallel (``moe.moe_epsum_train``) where ``rt``'s tensor axis
    splits the experts. ``gather`` (FSDP) makes the layer's stored shards
    whole first, inside the remat'd block, so the backward gathers again."""
    if gather is not None:
        p = gather(p)
    if kind not in KV_KINDS:
        return recurrent_block(cfg, kind, p, x, "prefill", None)[0], {}
    x_mid, h2, _ = attn_half(cfg, p, x, "train", rt=rt)
    if kind != "attn_moe":
        return mlp_half(cfg, p, x_mid, h2, rt), {}
    if _expert_parallel(cfg, p, rt):
        y, aux = moe_mod.moe_epsum_train(p["moe"], cfg.moe, h2, rt.tp_group(), rt.tp_rank(),
                                         routing)
        return x_mid + y.reshape(x_mid.shape), aux
    y, aux = moe_mod.moe_forward(p["moe"], cfg.moe, h2.reshape(x_mid.shape),
                                 rt.sharding.moe_impl, routing)
    return x_mid + y, aux


def forward_train(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # [B, S_tok]
    rt: Runtime,
    frontend: Optional[torch.Tensor] = None,
    routes: Optional[List[moe_mod.Routing]] = None,
    gather: Optional[Callable[[str, Any], Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, S_tok] -> (hidden [B, S_total, D] before the final norm,
    aux): the MoE losses summed over the layers (``moe_load_balance``,
    ``moe_router_z``; ``moe_dropped_frac`` under sorted dispatch).
    ``routes``: one ``moe.Routing`` per MoE layer, recording each layer's
    top-k choice or replaying it. Under ``rt.mesh`` (this rank's rows and
    parameter shards) the layers take their tensor-parallel train forms and
    the embedding is vocabulary-parallel where ``embed`` holds this rank's
    rows. ``gather(path, subtree)`` (FSDP storage) gives a subtree's leaves
    whole over the data axis; each layer calls it inside its remat'd block."""
    embed = params["embed"] if gather is None else gather("embed", params["embed"])
    x = prepend_frontend(cfg, params, _embed(cfg, {"embed": embed}, tokens, rt), frontend)
    policy = rt.sharding.remat_policy
    aux_tot: Dict[str, torch.Tensor] = {}
    mi = 0
    for li, (kind, p) in enumerate(zip(cfg.layer_kinds, params["layers"])):
        routing = None
        if kind == "attn_moe":
            routing = routes[mi] if routes is not None else None
            mi += 1
        at = None if gather is None else functools.partial(gather, f"layers/{li}")
        x, aux = _remat(functools.partial(_train_block, cfg, rt, kind, p, routing, at), policy)(x)
        for n, v in aux.items():
            aux_tot[f"moe_{n}"] = aux_tot[f"moe_{n}"] + v if f"moe_{n}" in aux_tot else v
    return x, aux_tot


def _chunk_loss(hc: torch.Tensor, tc: torch.Tensor,
                head: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed next-token cross-entropy of one chunk (f32 logits), and its
    count of labels that are not -1."""
    logits = (hc @ head).float()
    gold = torch.gather(logits, -1, torch.clamp(tc, min=0).long()[..., None])[..., 0]
    valid = (tc >= 0).float()
    return ((torch.logsumexp(logits, dim=-1) - gold) * valid).sum(), valid.sum()


def _vocab_chunk_loss(rank: int, group, hc: torch.Tensor, tc: torch.Tensor,
                      head: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_chunk_loss` over a head holding this rank's vocabulary
    columns [D, V/tp] (``parallel.vocab_parallel_xent``): the [.., V/tp]
    logits of this rank only, hc's partial gradients summed over the axis."""
    logits = (parallel.copy_to_tp(hc, group) @ head).float()
    valid = (tc >= 0).float()
    return (parallel.vocab_parallel_xent(logits, tc, rank, group) * valid).sum(), valid.sum()


def loss_targets(cfg: ModelConfig, labels: torch.Tensor) -> torch.Tensor:
    """The labels the loss scores: every token under a frontend, else
    ``labels[:, 1:]`` (position i predicts label i + 1)."""
    return labels if cfg.frontend is not None and cfg.frontend_len > 0 else labels[:, 1:]


def lm_loss(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # [B, S_tok]
    labels: torch.Tensor,             # [B, S_tok], -1 = ignore
    rt: Runtime,
    frontend: Optional[torch.Tensor] = None,
    routes: Optional[List[moe_mod.Routing]] = None,
    count: Optional[torch.Tensor] = None,
    aux_weight: float = 1.0,
    gather: Optional[Callable[[str, Any], Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (the reference's ``lm_loss``): the head and
    the log-softmax over ``rt.loss_chunk`` positions at a time, each chunk
    recomputed in the backward, so [B, S, V] never exists at once. A
    frontend arch predicts every token from the position before it (the
    last frontend position predicts the first token); else position i
    predicts label i + 1. An MoE model adds ``router_aux_coef`` x the
    load-balance loss and ``router_z_coef`` x the z-loss, each summed over
    the layers and divided by ``num_layers``. Returns (loss, aux with
    ``lm_loss``, the loss, and ``lm_xent``, its cross-entropy part).

    Data parallelism (``training/trainer.py``): ``count`` replaces the
    count of valid labels in the divisor (the whole batch's, over every
    data rank) and ``aux_weight`` scales the MoE terms (1 / the data
    ranks), so the ranks' losses sum to the global batch's. Under
    ``rt.mesh`` a head holding this rank's vocabulary columns scores each
    chunk vocabulary-parallel (:func:`_vocab_chunk_loss`); ``gather`` as in
    :func:`forward_train` (the head gathered once, before the chunks)."""
    h, aux = forward_train(cfg, params, tokens, rt, frontend, routes, gather)
    f = cfg.frontend_len if cfg.frontend is not None else 0
    pred_h, tgt = h[:, f - 1:-1] if f > 0 else h[:, :-1], loss_targets(cfg, labels)
    s = pred_h.shape[1]
    chunk = min(rt.loss_chunk, s)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = params[name] if gather is None else gather(name, params[name])
    head = head.T if cfg.tie_embeddings else head
    hn = apply_norm(cfg.norm, params["final_norm"], pred_h)
    loss_fn = _remat(_chunk_loss, "full")
    if _tensor_axis(rt) and head.shape[1] < cfg.vocab_size:
        loss_fn = _remat(functools.partial(_vocab_chunk_loss, rt.tp_rank(), rt.tp_group()),
                         "full")
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, chunk):
        l, c = loss_fn(hn[:, start:start + chunk], tgt[:, start:start + chunk], head)
        tot, cnt = tot + l, cnt + c
    loss = xent = tot / torch.clamp(cnt if count is None else count, min=1.0)
    if cfg.has_moe:
        m, n = cfg.moe, max(cfg.num_layers, 1)
        loss = loss + aux_weight * m.router_aux_coef * aux.get("moe_load_balance", 0.0) / n
        loss = loss + aux_weight * m.router_z_coef * aux.get("moe_router_z", 0.0) / n
    aux["lm_loss"] = loss
    aux["lm_xent"] = xent.detach()
    return loss, aux
