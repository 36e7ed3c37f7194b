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
data rank's rows and its parameters (``shard_params``: an MoE layer's routed
experts split on E over the tensor axis, everything else whole).
``prefill_model`` then runs the reference's whole-batch prefill with each
MoE layer expert-parallel (``moe.moe_epsum_local``) and, for a long prompt
whose heads the tensor axis does not divide, each attention layer's queries
split over the axis (``_sp_attention``: K4's chunk entry at the rank's
offset, then an all-gather); ``decode_model`` runs each MoE layer's
expert-parallel decode (``moe.moe_epsum_decode_local``). Rows split over the
data axis need no collective.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils import checkpoint as ckpt

from repro_torch.config.base import KV_KINDS, ModelConfig, ShardingConfig
from repro_torch.distributed.sharding import shard_tensor
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
    full-width warehouse never sits on the card whole."""
    device = torch.device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
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


def lm_logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg.norm, params["final_norm"], h)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


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
    chunk lengths, no kernel). Under ``rt.mesh`` a long ``prefill`` whose
    heads do not divide the tensor axis splits its queries over the axis
    (:func:`_sp_attention`)."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    if mode == "train":
        rt = rt or Runtime()
        y = attn.attention_train(p["attn"], cfg.attention, h,
                                 q_chunk=rt.q_chunk, kv_chunk=rt.kv_chunk)
    elif mode == "prefill" and _use_sp(cfg, rt, x.shape[1]):
        y, state = _sp_attention(p["attn"], cfg.attention, rt, h, cache_len, state)
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
    the output projection and the KV cache (written in place, ring-indexed
    for a window, as ``attention_prefill``'s) are computed whole on every
    rank. Returns (y [B, S, D], cache)."""
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
    return y, attn.write_cache(acfg, k, v, cache_len, cache)


def mlp_half(cfg: ModelConfig, p: Params, x_mid: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """A dense layer's FFN half: x_mid + MLP(h2 [T, D]), in x_mid's shape."""
    return x_mid + apply_mlp(cfg.mlp, p["mlp"], h2).reshape(x_mid.shape)


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
    Under ``rt.mesh`` (this rank's rows and parameters, no residency) each
    MoE layer runs expert-parallel decode
    (``moe.moe_epsum_decode_local``: local experts, one all-reduce).
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
    b = token.shape[0]
    rows = b if page_table is not None else next(iter(state[0].values())).shape[0]
    if rows > b:
        token = torch.cat([token, token.new_zeros(rows - b)])
        if isinstance(cur_len, torch.Tensor) and cur_len.numel() > 1:
            cur_len = torch.cat([cur_len, cur_len.new_zeros(rows - b)])
    x = embed_tokens(params, token[:, None])
    x, aux = _run_stack(cfg, params, x, "decode", state, cur_len, residency, page_table, rt)
    return lm_logits(cfg, params, x[:b, -1:])[:, 0], aux


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
    once, as in the reference: attention per row, split over the tensor
    axis by query positions where :func:`_use_sp` holds; each MoE layer
    expert-parallel over the B*S tokens at the reference's capacity
    (``moe.moe_forward(impl="epsum")``, so pads count as tokens, as they do
    there); a recurrent layer's cell over the batch. Returns (logits [B, V]
    at ``last_index`` (default the last position), the state)."""
    b = tokens.shape[0]
    x = prepend_frontend(cfg, params, embed_tokens(params, tokens), frontend)
    state = zero_state(cfg, rows or b, cache_len, tokens.device)
    for li, (kind, p) in enumerate(zip(cfg.layer_kinds, params["layers"])):
        layer = {n: t[:b] for n, t in state[li].items()}
        if kind not in KV_KINDS:
            x, new = recurrent_block(cfg, kind, p, x, "prefill", None)
            _store(layer, new)
            continue
        x_mid, h2, _ = attn_half(cfg, p, x, "prefill", layer, 0, cache_len, rt=rt)
        if "moe" not in p:
            x = mlp_half(cfg, p, x_mid, h2)
            continue
        y2, _ = moe_mod.moe_forward(p["moe"], cfg.moe, h2.reshape(x_mid.shape), "epsum",
                                    mesh=rt.mesh, ep_axis=rt.ep_axis())
        x = x_mid + y2
    last = x[:, -1] if last_index is None else x[torch.arange(b, device=x.device),
                                                    last_index.reshape(-1).long()]
    return lm_logits(cfg, params, last[:, None])[:, 0], state


def moe_param_specs(p_moe: Params, tp_axis: str) -> Params:
    """An MoE layer's storage under a mesh (the reference's
    ``_moe_param_specs``): routed experts split on E over ``tp_axis``, the
    router and shared experts replicated."""
    specs: Params = {"router": (None, None),
                     "experts": {n: (tp_axis, None, None) for n in p_moe["experts"]}}
    if "shared" in p_moe:
        specs["shared"] = {n: (None, None) for n in p_moe["shared"]}
        specs["shared_gate"] = (None, None)
    return specs


def shard_params(params: Params, rt: Runtime) -> Params:
    """This rank's parameters for the sharded forward: each MoE layer as
    :func:`moe_param_specs` cuts it (the local experts a copy, so the whole
    store can be freed), every other tensor shared with ``params``."""
    axis = rt.sharding.tp_axis
    layers = []
    for p in params["layers"]:
        if "moe" in p:
            specs = moe_param_specs(p["moe"], axis)
            moe = {n: ({w: shard_tensor(t, specs[n][w], rt.mesh) for w, t in v.items()}
                       if isinstance(v, dict) else v)
                   for n, v in p["moe"].items()}
            p = {**p, "moe": moe}
        layers.append(p)
    return {**params, "layers": layers}


def prefill_chunk_model(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # [B, C] the chunk's tokens
    state: List[Dict[str, torch.Tensor]],
    cur_len: Union[int, torch.Tensor],  # tokens already cached (int or device scalar)
    residency: Optional[List[Tuple[Params, torch.Tensor]]] = None,
    with_head: bool = True,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """One prefill chunk: append C prompt positions to the caches (in place)
    through every layer in ``chunk`` mode, the multi-token sibling of
    :func:`decode_model`; the MoE half routes all B*C chunk tokens (K3's
    fused entry) and, past ``moe.PER_PICK_MAX`` picks, runs K1's ragged
    entry. Returns (logits [B, V] at the chunk's last position, or None with
    ``with_head=False``, and aux), aux as :func:`decode_model`'s with T =
    B*C."""
    x = embed_tokens(params, tokens)
    x, aux = _run_stack(cfg, params, x, "chunk", state, cur_len, residency)
    if not with_head:
        return None, aux
    return lm_logits(cfg, params, x[:, -1:])[:, 0], aux


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
    ``page_table`` (decode): ``state`` is the paged pool. ``rt.mesh``
    (decode, no residency): the MoE half is expert-parallel."""
    d = x.shape[-1]
    ep_axis = None
    if rt is not None and rt.mesh is not None:
        if mode != "decode" or residency is not None:
            raise ValueError("under a mesh the stack runs decode steps without residency")
        if cfg.has_moe:
            ep_axis = rt.ep_axis()
    tel: Dict[str, List[torch.Tensor]] = {n: [] for n in ("ids", "weights", "miss", "h", "x")}
    for li, (kind, p, mi) in enumerate(zip(cfg.layer_kinds, params["layers"],
                                           moe_ordinals(params))):
        if kind not in KV_KINDS:
            x, new = recurrent_block(cfg, kind, p, x, mode, state[li])
            _store(state[li], new)
            continue
        x_in = x
        x_mid, h2, _ = attn_half(cfg, p, x, mode, state[li], cur_len, 0, page_table)
        if mi is None:
            x = mlp_half(cfg, p, x_mid, h2)
            continue
        ids, weights = moe_mod.route(p["moe"], h2, cfg.moe)
        if ep_axis is not None:
            y2 = moe_mod.moe_epsum_decode_local(p["moe"], cfg.moe, h2, ids, weights,
                                                mesh=rt.mesh, ep_axis=ep_axis)
            miss = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        else:
            slots, lut = residency[mi] if residency is not None else (None, None)
            y2, miss = moe_mod.moe_apply_routed(p["moe"], h2, ids, weights,
                                                slot_buffer=slots, lut=lut)
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
    ``cur_len`` [B]; each row draws at its own positions.
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
        logits, aux = decode_model(cfg, params, tok, state, cur_len + j, residency, page_table)
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


def snapshot_kv_window(state: List[Dict[str, torch.Tensor]],
                       cur_len: Union[int, torch.Tensor],
                       k_steps: int,
                       page_table: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Pre-window copies of the KV slots the next ``k_steps`` positions
    overwrite, per layer ``{"k", "v"}`` [B, K, Hkv, dh]: what
    :func:`rollback_kv_window` restores (zeros for a full cache, the previous
    lap's entries for a ring cache). ``page_table`` [B, pages]: ``state`` is
    the paged pool, read through each row's pages. A recurrent layer's
    entry is empty (nothing of it can be rolled back)."""
    out: List[Dict[str, torch.Tensor]] = []
    for cache in state:
        if "k" not in cache:
            out.append({})
            continue
        rows, slots = _window_index(cache["k"], cur_len, k_steps, page_table)
        out.append({n: cache[n][rows, slots] for n in ("k", "v")})
    return out


def rollback_kv_window(state: List[Dict[str, torch.Tensor]],
                       saved: List[Dict[str, torch.Tensor]],
                       cur_len: Union[int, torch.Tensor], k_steps: int,
                       keep: Union[int, torch.Tensor],
                       page_table: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """KV truncate after a partly rejected window, IN PLACE: the slots of
    window offsets ``>= keep`` (scalar or per-row [B]) get their ``saved``
    pre-window contents back, offsets ``< keep`` (the accepted prefix) stay.
    The cache then equals the one a sequential decode holds at length
    ``cur_len + keep``. ``page_table`` [B, pages]: the paged pool, written
    through each row's pages (pad rows' duplicate writes land in the scratch
    page). Returns ``state``."""
    for cache, sv in zip(state, saved):
        if not sv:
            continue
        rows, slots = _window_index(cache["k"], cur_len, k_steps, page_table)
        b = slots.shape[0]
        kp = torch.as_tensor(keep, device=slots.device).to(torch.int64).reshape(-1).expand(b)
        mask = (torch.arange(k_steps, device=slots.device)[None, :] >= kp[:, None])[..., None, None]
        for n in ("k", "v"):
            c = cache[n]
            c[rows, slots] = torch.where(mask, sv[n], c[rows, slots])
    return state


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
                 routing: Optional[moe_mod.Routing],
                 x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer's train form (the reference's ``_apply_block`` in mode
    ``train``): x [B, S, D] -> (x out, aux: the MoE layer's losses). The
    blocks the engines run, with ``train`` attention, a recurrent cell's
    prefill without its state, and the MoE half through ``moe_forward``."""
    if kind not in KV_KINDS:
        return recurrent_block(cfg, kind, p, x, "prefill", None)[0], {}
    x_mid, h2, _ = attn_half(cfg, p, x, "train", rt=rt)
    if kind != "attn_moe":
        return mlp_half(cfg, p, x_mid, h2), {}
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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, S_tok] -> (hidden [B, S_total, D] before the final norm,
    aux): the MoE losses summed over the layers (``moe_load_balance``,
    ``moe_router_z``; ``moe_dropped_frac`` under sorted dispatch).
    ``routes``: one ``moe.Routing`` per MoE layer, recording each layer's
    top-k choice or replaying it."""
    x = prepend_frontend(cfg, params, embed_tokens(params, tokens), frontend)
    policy = rt.sharding.remat_policy
    aux_tot: Dict[str, torch.Tensor] = {}
    mi = 0
    for kind, p in zip(cfg.layer_kinds, params["layers"]):
        routing = None
        if kind == "attn_moe":
            routing = routes[mi] if routes is not None else None
            mi += 1
        x, aux = _remat(functools.partial(_train_block, cfg, rt, kind, p, routing), policy)(x)
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


def lm_loss(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,             # [B, S_tok]
    labels: torch.Tensor,             # [B, S_tok], -1 = ignore
    rt: Runtime,
    frontend: Optional[torch.Tensor] = None,
    routes: Optional[List[moe_mod.Routing]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (the reference's ``lm_loss``): the head and
    the log-softmax over ``rt.loss_chunk`` positions at a time, each chunk
    recomputed in the backward, so [B, S, V] never exists at once. A
    frontend arch predicts every token from the position before it (the
    last frontend position predicts the first token); else position i
    predicts label i + 1. An MoE model adds ``router_aux_coef`` x the
    load-balance loss and ``router_z_coef`` x the z-loss, each summed over
    the layers and divided by ``num_layers``. Returns (loss, aux with
    ``lm_loss``)."""
    h, aux = forward_train(cfg, params, tokens, rt, frontend, routes)
    f = cfg.frontend_len if cfg.frontend is not None else 0
    pred_h, tgt = (h[:, f - 1:-1], labels) if f > 0 else (h[:, :-1], labels[:, 1:])
    s = pred_h.shape[1]
    chunk = min(rt.loss_chunk, s)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    hn = apply_norm(cfg.norm, params["final_norm"], pred_h)
    loss_fn = _remat(_chunk_loss, "full")
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, chunk):
        l, c = loss_fn(hn[:, start:start + chunk], tgt[:, start:start + chunk], head)
        tot, cnt = tot + l, cnt + c
    loss = tot / torch.clamp(cnt, min=1.0)
    if cfg.has_moe:
        m, n = cfg.moe, max(cfg.num_layers, 1)
        loss = loss + m.router_aux_coef * aux.get("moe_load_balance", 0.0) / n
        loss = loss + m.router_z_coef * aux.get("moe_router_z", 0.0) / n
    aux["lm_loss"] = loss
    return loss, aux
