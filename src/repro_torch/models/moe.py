"""Mixture-of-Experts FFN for the engine path: router, top-k, routed experts
through the slot LUT, shared experts.

The counterpart of ``repro/models/moe.py``'s ``router_logits``, ``topk_route``
and ``moe_apply_routed``. Routing (``route``) runs the router GEMM and the
top-k gate as one launch of the gate kernel's fused entry (K3). The
routed experts run the slot-LUT grouped matmul (K1) three times (gate, up,
down) around the SwiGLU gate, as the reference's ``moe_slot_ffn`` does,
instead of gathering a [T, k, D, F] weight copy per token as
``moe_apply_routed`` does — at a 512-token prompt with top-8 that gather is
about 13 GB per weight tensor. Two groupings feed K1:

* few tokens (decode): every (token, pick) is its own group with C = 1, its
  LUT entry the pick's slot — no host round trip;
* many tokens (a prefill chunk, or the legacy walk's whole prompt): the
  picks' rows sorted by slot on the device (a stable argsort of the T*k
  slot ids) with each slot's first row found there too (a search of the
  sorted ids), through K1's ragged entry, so each resident slot is read
  once per layer and no count reaches the host: a CUDA graph can capture
  it.

Misses keep the reference's sentinel: a routed expert whose LUT entry is
the planes' last row (``num_slots`` for one generation of slots, the second
generation's zero row when two are folded into the planes) reads
zeros and its weight is dropped; the engine corrects it on the host.

The training forward's dispatch (``moe_forward``: ``moe_dense``,
``moe_sorted``) is the reference's, in plain PyTorch and differentiable (K1
and K3 have no backward): ``topk_route_aux`` routes with the load-balance
and z losses, and each expert keeps at most ``capacity(mcfg, T)``
assignments, the rest dropped in the reference's order (``moe_sorted``:
token-major; ``moe_dense``: k-major within each batch row). A scatter
carries the sorted dispatch and a gather the combine (each token's k
outputs summed in k order), so on the card the backward gathers, or
accumulates by sorted index, never by atomics in a varying order: two runs
give the same bits.

Expert parallelism over a mesh axis (the reference's ``epsum``), each rank
holding E/ep routed experts: ``moe_epsum_local`` (the sharded prefill: the
sorted dispatch over the local experts at the reference's capacity, the
local FFN through K1's tiled grouped entry, one all-reduce) and
``moe_epsum_decode_local`` (decode: K1's GEMV over the picks that route to
local experts, one all-reduce). Training over the mesh runs
``moe_epsum_train``: the same dispatch in plain, differentiable PyTorch,
with the router losses.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, gelu

PER_PICK_MAX = 64     # up to this many (token, pick) pairs: one group each

Aux = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig, mlp_kind: str,
             dtype: torch.dtype, device, expert_device=None) -> Params:
    """Router (f32), routed experts [E, D, F] / [E, F, D] (on ``expert_device``,
    default ``device``) and optional fused shared experts + their gate."""
    e, f = mcfg.storage_experts, mcfg.expert_d_ff
    device = torch.device(device)
    edev = device if expert_device is None else torch.device(expert_device)
    p: Params = {"router": dense_init(gen, (d_model, mcfg.num_experts), torch.float32, device)}

    def expert(shape, fan_in=None):
        w = dense_init(gen, shape, dtype, device, fan_in=fan_in)
        return w if edev == device else _to_host(w, edev)

    # each expert scaled by its own fan-in (d_model in, expert_d_ff out); the
    # reference scales gate/up by the expert COUNT, which at full width makes
    # every MoE layer multiply the residual's scale and bf16 rounding chaotic
    if mlp_kind == "swiglu":
        p["experts"] = {
            "w_gate": expert((e, d_model, f), fan_in=d_model),
            "w_up": expert((e, d_model, f), fan_in=d_model),
            "w_down": expert((e, f, d_model), fan_in=f),
        }
    else:
        p["experts"] = {
            "w_up": expert((e, d_model, f), fan_in=d_model),
            "w_down": expert((e, f, d_model), fan_in=f),
        }
    if mcfg.num_shared_experts > 0:
        sf = mcfg.shared_d_ff * mcfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (d_model, sf), dtype, device),
            "w_up": dense_init(gen, (d_model, sf), dtype, device),
            "w_down": dense_init(gen, (sf, d_model), dtype, device, fan_in=sf),
        }
        p["shared_gate"] = dense_init(gen, (d_model, 1), dtype, device)
    return p


def _to_host(w: torch.Tensor, host_device) -> torch.Tensor:
    """Copy a device tensor to host memory, pinned when a card is present."""
    out = torch.empty(w.shape, dtype=w.dtype, device=host_device,
                      pin_memory=w.device.type == "cuda")
    out.copy_(w)
    return out


def route(p: Params, x2d: torch.Tensor, mcfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [T, D] -> (ids [T, k] int32, weights [T, k] f32): the router GEMM
    and the top-k gate in one call (``router_logits`` then ``topk_route``;
    on the card one launch of K3's fused entry). Every routing site of the
    engine (fused decode step, prefill walk, suffix replay) calls this."""
    return ops.router_topk(x2d, p["router"], mcfg.top_k, normalize=mcfg.norm_topk_prob)


def router_logits(p: Params, x2d: torch.Tensor) -> torch.Tensor:
    """x2d [T, D] -> router logits f32 [T, E]."""
    return x2d.float() @ p["router"]


def topk_route(logits: torch.Tensor, mcfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] -> (ids [T, k] int32, weights [T, k] f32), lowest index
    first on ties, renormalized when ``norm_topk_prob``."""
    return ops.topk_gate(logits, mcfg.top_k, normalize=mcfg.norm_topk_prob)


def shared_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    if "w_gate" in sp:
        h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
    else:
        h = gelu(x @ sp["w_up"])
    return (h @ sp["w_down"]) * torch.sigmoid(x @ p["shared_gate"])


def expert_ffn(src: Params, xs: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Grouped expert FFN through the store: xs [G, C, D], lut [G] -> [G, C, D]
    (the reference's ``moe_slot_ffn``: three K1 calls + the gate). ``src``
    holds ``w_*`` and, for quantized slots, their ``scale_w_*`` / ``min_w_*``
    planes; those give f32 gate/up outputs, and the hidden returns to x's
    type before the down matrix. The output is f32 when quantized."""
    return _ffn(src, xs, lambda name, x: ops.slot_gmm(
        x, src[name], lut, src.get(f"scale_{name}"), src.get(f"min_{name}")))


def expert_ffn_ragged(src: Params, xs: torch.Tensor, offsets: torch.Tensor,
                      miss_slot: Optional[int] = None) -> torch.Tensor:
    """:func:`expert_ffn` on rows sorted by slot: xs [N, D], ``offsets``
    [S1+1] (slot s owns rows ``offsets[s] .. offsets[s+1]``) -> [N, D]."""
    return _ffn(src, xs, lambda name, x: ops.slot_gmm_ragged(
        x, src[name], offsets, src.get(f"scale_{name}"), src.get(f"min_{name}"),
        miss_slot=miss_slot))


def _ffn(src: Params, xs: torch.Tensor,
         gmm: Callable[[str, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """SwiGLU (or GELU) around ``gmm(weight name, x)``, one of K1's entries."""
    if "w_gate" in src:
        h = F.silu(gmm("w_gate", xs)) * gmm("w_up", xs)
    else:
        h = gelu(gmm("w_up", xs))
    return gmm("w_down", h.to(xs.dtype))


def moe_apply_routed(
    p: Params,
    x2d: torch.Tensor,                    # [T, D]
    ids: torch.Tensor,                    # [T, k] int (precomputed routing)
    weights: torch.Tensor,                # [T, k] f32
    *,
    slot_buffer: Optional[Params] = None,
    lut: Optional[torch.Tensor] = None,   # [E] int: expert -> row, last row = MISS
    include_shared: bool = True,
    tp_group=None,
    mcfg: Optional[MoEConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply already-routed experts. Returns (y [T, D], miss [T, k] bool).
    More than ``PER_PICK_MAX`` picks take the ragged grouping (on the
    device).

    ``tp_group`` (rotary residency under the tensor axis): ``slot_buffer``
    holds this rank's slice of the expert width F (``residency_spec``), so
    the same groupings run on the slice (the SwiGLU is elementwise) and
    ``w_down``'s F/tp rows give a partial sum; weighted and summed over the
    picks in f32, it is summed over the axis by one f32 all-reduce before
    the cast. Shared experts split over the axis (``shared_split`` under
    ``mcfg``) add their partial sum before it, whole ones after it. The
    miss mask depends on the LUT alone: the same on every rank."""
    t, k = ids.shape
    ids_l = ids.long()
    if slot_buffer is not None:
        assert lut is not None
        num_slots = slot_buffer["w_up"].shape[0] - 1
        slots = lut[ids_l]
        miss = slots >= num_slots
        gidx = torch.where(miss, torch.full_like(slots, num_slots), slots)
        src = slot_buffer
    else:
        num_slots = None
        miss = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        gidx = ids_l
        src = p["experts"]
    w_eff = weights.float() * (~miss).float()
    if t * k <= PER_PICK_MAX:
        xs = x2d.repeat_interleave(k, dim=0)[:, None, :]           # [T*k, 1, D]
        outs = expert_ffn(src, xs, gidx.reshape(-1))[:, 0]          # [T*k, D]
    else:
        outs = _ragged(src, x2d, gidx, num_slots)                  # [T*k, D]
    y = (outs.float().reshape(t, k, -1) * w_eff[..., None]).sum(dim=1)
    if tp_group is not None:
        split = include_shared and shared_split(p, mcfg)
        if split:
            y = y + shared_ffn(p, x2d).float()
        y = parallel.all_reduce_f32(y, tp_group).to(x2d.dtype)
        if include_shared and "shared" in p and not split:
            y = y + shared_ffn(p, x2d)
        return y, miss
    y = y.to(x2d.dtype)
    if include_shared and "shared" in p:
        y = y + shared_ffn(p, x2d)
    return y, miss


def _ragged(src: Params, x2d: torch.Tensor, gidx: torch.Tensor,
            miss_slot: Optional[int]) -> torch.Tensor:
    """The picks' rows sorted by slot (a stable argsort of the T*k store
    rows; missed picks read ``miss_slot``, the last row, and sort last) and
    each slot's first row (a search of the sorted rows), both on the device;
    the FFN through K1's ragged entry, which leaves MISS rows zero; the
    outputs back in pick order. Returns [T*k, D]."""
    t, k = gidx.shape
    flat = gidx.reshape(-1)
    n_store = int(src["w_up"].shape[0])
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(n_store + 1, dtype=flat.dtype, device=x2d.device)
    offsets = torch.searchsorted(flat[order], bounds).to(torch.int32)   # [S1+1]
    xs = x2d.index_select(0, order // k)                                # [T*k, D]
    ys = expert_ffn_ragged(src, xs, offsets, miss_slot)
    return torch.empty_like(ys).index_copy_(0, order, ys)



# ---------------------------------------------------------------------------
# Training / prefill dispatch with a capacity (plain PyTorch, differentiable)
# ---------------------------------------------------------------------------
@dataclass
class Routing:
    """One MoE layer's top-k choice in a training forward. A forward given a
    ``Routing`` records its ids [T, k] there; with ``replay`` it takes them
    instead of its own top-k (its gate weights and aux losses still come
    from its own router probabilities). Drops are a function of the ids and
    the capacity, so a replayed forward drops the same assignments: an f32
    recomputation of a bf16 step replays the bf16 routing."""

    ids: Optional[torch.Tensor] = None
    replay: bool = False


def capacity(mcfg: MoEConfig, tokens: int) -> int:
    """Assignments kept per expert over ``tokens`` routed tokens (the
    reference's ``max(k, ceil(T*k/E * capacity_factor))``)."""
    k = mcfg.top_k
    return max(k, int(math.ceil(tokens * k / mcfg.num_experts * mcfg.capacity_factor)))


def topk_route_aux(logits: torch.Tensor, mcfg: MoEConfig,
                   routing: Optional[Routing] = None) -> Tuple[torch.Tensor, torch.Tensor, Aux]:
    """logits [T, E] f32 -> (ids [T, k] int64, weights [T, k] f32, aux): the
    reference's ``topk_route`` in plain PyTorch, differentiable through the
    weights, with its Switch load-balance loss and router z-loss."""
    probs = torch.softmax(logits, dim=-1)
    if routing is not None and routing.replay:
        ids = routing.ids
        weights = torch.gather(probs, 1, ids)
    else:
        weights, ids = torch.topk(probs, mcfg.top_k, dim=-1)
        if routing is not None:
            routing.ids = ids.detach()
    if mcfg.norm_topk_prob:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e = mcfg.num_experts
    frac_tokens = F.one_hot(ids, e).float().sum(dim=1).mean(dim=0)          # [E]
    aux: Aux = {
        "load_balance": e * torch.sum(frac_tokens / mcfg.top_k * probs.mean(dim=0)),
        "router_z": torch.logsumexp(logits, dim=-1).square().mean(),
    }
    return ids, weights, aux


def expert_ranks(keys: torch.Tensor) -> torch.Tensor:
    """keys [N] int64 -> each entry's rank among the earlier entries of its
    key (0 for the first): a stable sort, each key's first sorted position
    found by a search, the ranks scattered back to the input order."""
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    pos = torch.arange(keys.numel(), device=keys.device) - torch.searchsorted(ks, ks)
    return torch.zeros_like(keys).scatter(0, order, pos)


def capacity_keep(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """ids [T, k] -> keep [T, k]: False for an assignment past its expert's
    first ``cap`` in token-major order (``moe_sorted``'s drops)."""
    return (expert_ranks(ids.reshape(-1)) < cap).reshape(ids.shape)


def expert_ffn_dense(experts: Params, xs: torch.Tensor) -> torch.Tensor:
    """The reference's ``_expert_ffn``: xs [E, C, D] against the stacked
    weights -> [E, C, D], batched matmuls in x's type with f32 sums (the
    reference computes it with ``einsum``, outside any Pallas kernel)."""
    if "w_gate" in experts:
        h = F.silu(torch.bmm(xs, experts["w_gate"])) * torch.bmm(xs, experts["w_up"])
    else:
        h = gelu(torch.bmm(xs, experts["w_up"]))
    return torch.bmm(h, experts["w_down"])


def sorted_dispatch(x2d: torch.Tensor, ids: torch.Tensor, num_experts: int,
                    cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``sorted_dispatch``: x2d [T, D], ids [T, k] -> (buffer
    [E, C, D], dest [T*k], tok [T*k]). Assignment (t, j) to expert e writes
    token t into row ``e * C + rank`` of the buffer, ``rank`` counting the
    earlier tokens routed to e; past C it is dropped (dest -1; its write
    lands in an overflow row cut off afterwards)."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    ranks = expert_ranks(flat)
    keep = ranks < cap
    tok = torch.arange(t, device=x2d.device).repeat_interleave(k)
    slot = torch.where(keep, flat * cap + ranks, torch.full_like(flat, num_experts * cap))
    buf = x2d.new_zeros((num_experts * cap + 1, x2d.shape[-1])).index_put((slot,), x2d[tok])
    return (buf[:-1].reshape(num_experts, cap, -1),
            torch.where(keep, slot, torch.full_like(slot, -1)), tok)


def moe_sorted(p: Params, mcfg: MoEConfig, x2d: torch.Tensor, cap: Optional[int] = None,
               routing: Optional[Routing] = None) -> Tuple[torch.Tensor, Aux]:
    """x2d [T, D] -> [T, D] by sorted dispatch (the reference's
    ``moe_sorted``) at capacity ``cap`` (default ``capacity(mcfg, T)``): the
    experts run as batched matmuls over the [E, C, D] buffer, and each token
    gathers its k outputs back, weighted in x's type and summed in f32 in k
    order. A dropped assignment gathers a row of its own (``E * C >= T * k``
    rows, so the gradient's accumulation meets no hot index) times a zero
    weight. aux adds ``dropped_frac``."""
    t, d = x2d.shape
    e, k = mcfg.storage_experts, mcfg.top_k
    cap = cap or capacity(mcfg, t)
    ids, weights, aux = topk_route_aux(router_logits(p, x2d), mcfg, routing)
    buf, dest, _ = sorted_dispatch(x2d, ids, e, cap)
    out = expert_ffn_dense(p["experts"], buf).reshape(e * cap, d)
    valid = dest >= 0
    y = combine(out, dest, valid, weights).to(x2d.dtype)
    if mcfg.num_shared_experts > 0:
        y = y + shared_ffn(p, x2d)
    aux["dropped_frac"] = 1.0 - valid.float().mean()
    return y, aux


def combine(out: torch.Tensor, dest: torch.Tensor, valid: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """The sorted dispatch's combine: out [N, D] expert rows, ``dest``
    [T*k] each assignment's row, ``valid`` [T*k] whether it was kept,
    weights [T, k] -> f32 [T, D]. Each token gathers its k outputs, weighted
    in out's type and summed in f32 in k order; an assignment not kept
    gathers a row of its own (N >= T*k rows, so the gradient's
    accumulation meets no hot index) times a zero weight."""
    t, k = weights.shape
    spread = torch.arange(t * k, device=out.device) % out.shape[0]
    rows = torch.where(valid, dest, spread).reshape(t, k)
    contrib = out[rows] * (weights * valid.reshape(t, k)).to(out.dtype)[..., None]  # [T, k, D]
    y = contrib[:, 0].float()
    for j in range(1, k):
        y = y + contrib[:, j].float()
    return y


def moe_dense(p: Params, mcfg: MoEConfig, x: torch.Tensor,
              routing: Optional[Routing] = None) -> Tuple[torch.Tensor, Aux]:
    """x [B, S, D] -> [B, S, D] by GShard one-hot dispatch (the reference's
    ``moe_dense``), capacity C = ``capacity(mcfg, S)`` per batch row, an
    assignment's place in its expert counted k-major within the row (every
    token's first pick before any second pick): dispatch and combine
    tensors [B, S, E, C], expert batches [B, E, C, D]."""
    b, s, d = x.shape
    e, k = mcfg.storage_experts, mcfg.top_k
    cap = capacity(mcfg, s)
    ids, weights, aux = topk_route_aux(router_logits(p, x.reshape(-1, d)), mcfg, routing)
    ids, weights = ids.reshape(b, s, k), weights.reshape(b, s, k)
    row = torch.arange(b, device=x.device)[:, None, None] * e
    keys = (ids + row).permute(0, 2, 1).reshape(-1)                          # k-major per row
    pos = expert_ranks(keys).reshape(b, k, s).permute(0, 2, 1)                # [B, S, k]
    keep = pos < cap
    oh_e = F.one_hot(ids, e)                                                  # [B, S, k, E]
    oh_c = F.one_hot(torch.where(keep, pos, torch.zeros_like(pos)), cap)      # [B, S, k, C]
    disp = torch.einsum("bske,bskc->bsec", (oh_e * keep[..., None]).to(x.dtype), oh_c.to(x.dtype))
    combine = torch.einsum("bske,bskc->bsec", oh_e.float() * (weights * keep)[..., None],
                           oh_c.float())
    xs = torch.einsum("bsec,bsd->becd", disp, x)                              # [B, E, C, D]
    out = expert_ffn_dense(p["experts"], xs.permute(1, 0, 2, 3).reshape(e, b * cap, d))
    out = out.reshape(e, b, cap, d).permute(1, 0, 2, 3)
    y = torch.einsum("becd,bsec->bsd", out.float(), combine).to(x.dtype)
    if mcfg.num_shared_experts > 0:
        y = y + shared_ffn(p, x)
    return y, aux


# ---------------------------------------------------------------------------
# Expert parallelism over a mesh axis (the reference's ``epsum``)
# ---------------------------------------------------------------------------
def shared_split(p_local: Params, mcfg: MoEConfig) -> bool:
    """Whether the shared experts hold this rank's columns / rows only
    (``param_spec`` cuts them as a dense MLP over the tensor axis)."""
    return ("shared" in p_local and p_local["shared"]["w_down"].shape[0]
            < mcfg.shared_d_ff * mcfg.num_shared_experts)


def _add_shared(p_local: Params, mcfg: MoEConfig, x_local: torch.Tensor, y: torch.Tensor,
                group) -> torch.Tensor:
    """The routed experts' partial output ``y`` summed over ``group`` with
    the shared experts: their partial sum joins ``y`` before the one
    all-reduce where they are split over the axis, else they run whole on
    every rank after it."""
    split = shared_split(p_local, mcfg)
    if split:
        y = y + shared_ffn(p_local, x_local)
    dist.all_reduce(y, group=group)
    if mcfg.num_shared_experts > 0 and not split:
        y = y + shared_ffn(p_local, x_local)
    return y


def _local_experts(p_local: Params, mesh, ep_axis: str) -> Tuple[int, int]:
    """(the first global expert this rank holds, how many): the experts are
    split on E in mesh order over ``ep_axis``."""
    e_loc = int(p_local["experts"]["w_up"].shape[0])
    return mesh.get_local_rank(ep_axis) * e_loc, e_loc


def moe_epsum_local(p_local: Params, mcfg: MoEConfig, x_local: torch.Tensor, *, mesh,
                    ep_axis: str = "model") -> Tuple[torch.Tensor, Aux]:
    """Expert-parallel MoE over the ``DeviceMesh`` axis ``ep_axis`` (the
    reference's ``moe_epsum_local``): x_local [T, D] are this data rank's
    tokens, the same on every rank of the axis; ``p_local`` holds the
    router and shared experts whole and this rank's E/ep routed experts.

    Every rank routes the tokens alike (K3's fused entry), runs the sorted
    dispatch over its local experts only at the reference's capacity
    ``max(k, ceil(T*k/E * cf))`` (assignments to other ranks' experts sort
    into a bucket that is cut off; the drops are the reference's), the local
    expert FFN as one grouped product ``x[g] @ W[g]`` through K1's tiled
    grouped entry (the [E/ep, C, D] buffer), and the combine; the partial
    outputs (in x's type) are summed by one ``all_reduce`` over the axis.
    Each token's expert work happens once, on the expert's owner. Shared
    experts run on every rank, whole or (split by the rules over the axis)
    as a partial sum inside the same all-reduce. Returns (y [T, D], {}):
    routing through K3 gives no router losses (the reference's aux is
    unused by its prefill; training runs :func:`moe_epsum_train`)."""
    lo, e_loc = _local_experts(p_local, mesh, ep_axis)
    t, d = x_local.shape
    ids, weights = route(p_local, x_local, mcfg)
    ids = ids.long()
    mine = (ids >= lo) & (ids < lo + e_loc)
    local_ids = torch.where(mine, ids - lo, torch.full_like(ids, e_loc))
    cap = capacity(mcfg, t)
    buf, dest, _ = sorted_dispatch(x_local, local_ids, e_loc + 1, cap)
    lut = torch.arange(e_loc, dtype=torch.int32, device=x_local.device)
    out = expert_ffn(p_local["experts"], buf[:e_loc], lut).reshape(e_loc * cap, d)
    valid = (dest >= 0) & (dest < e_loc * cap)
    y = combine(out, dest, valid, weights).to(x_local.dtype)
    return _add_shared(p_local, mcfg, x_local, y, mesh.get_group(ep_axis)), {}


def moe_epsum_train(p_local: Params, mcfg: MoEConfig, x_local: torch.Tensor, group,
                    rank: int, routing: Optional[Routing] = None) -> Tuple[torch.Tensor, Aux]:
    """:func:`moe_epsum_local` in training (the reference's
    ``moe_epsum_local`` under its ``shard_map``), plain and differentiable
    (K1 and K3 have no backward): x_local [T, D] this data rank's tokens,
    replicated over ``group`` (the tensor axis; this rank ``rank`` holds
    routed experts ``[rank E/tp, (rank+1) E/tp)``). Every rank routes alike
    (``topk_route_aux``, with the load-balance and z losses), runs the
    sorted dispatch over its local experts at the reference's capacity
    ``max(k, ceil(T k / E cf))`` (drops in its order), the local SwiGLU as
    batched products (``expert_ffn_dense``) and the combine; the partial
    outputs (with split shared experts' partial sums) are summed by
    ``reduce_from_tp``, whole shared experts added after it. x enters
    through ``copy_to_tp`` (its gradient, like the router's, is partial on
    each rank); the aux losses, alike on every rank, pass their gradient on
    rank 0 only (``count_once``). Returns (y [T, D], aux)."""
    t, d = x_local.shape
    e_loc = int(p_local["experts"]["w_up"].shape[0])
    lo = rank * e_loc
    x_in = parallel.copy_to_tp(x_local, group)
    ids, weights, aux = topk_route_aux(router_logits(p_local, x_in), mcfg, routing)
    mine = (ids >= lo) & (ids < lo + e_loc)
    local_ids = torch.where(mine, ids - lo, torch.full_like(ids, e_loc))
    cap = capacity(mcfg, t)
    buf, dest, _ = sorted_dispatch(x_in, local_ids, e_loc + 1, cap)
    out = expert_ffn_dense(p_local["experts"], buf[:e_loc]).reshape(e_loc * cap, d)
    valid = (dest >= 0) & (dest < e_loc * cap)
    y = combine(out, dest, valid, weights).to(x_local.dtype)
    split = shared_split(p_local, mcfg)
    if split:
        y = y + shared_ffn(p_local, x_in)
    y = parallel.reduce_from_tp(y, group)
    if mcfg.num_shared_experts > 0 and not split:
        y = y + shared_ffn(p_local, x_local)
    return y, {n: parallel.count_once(v, rank) for n, v in aux.items()}


def moe_epsum_decode_local(p_local: Params, mcfg: MoEConfig, x_local: torch.Tensor,
                           ids: torch.Tensor, weights: torch.Tensor, *, mesh,
                           ep_axis: str = "model") -> torch.Tensor:
    """Expert-parallel decode (the reference's ``moe_epsum_decode_local``):
    x_local [T, D] this data rank's decode tokens, routed already (ids,
    weights [T, k]); each rank applies its local experts to the picks that
    route to them and one [T, D] ``all_reduce`` over the axis sums the
    partials; shared experts on every rank (whole, or split inside the
    all-reduce).

    The reference multiplies every token by every local expert (the whole
    local store read once a step). Here each (token, pick) is a group of
    K1's GEMV body, its LUT entry the pick's local expert: a step reads the
    picked experts only (at qwen36's widths and two tokens a rank, about 8
    of 64 local experts a layer). A pick of another rank's expert reads
    local expert 0 (hot in L2 after the first) and is weighted 0. The sum
    is the reference's up to the order of f32 additions."""
    lo, e_loc = _local_experts(p_local, mesh, ep_axis)
    t, k = ids.shape
    ids = ids.long()
    mine = (ids >= lo) & (ids < lo + e_loc)
    lut = torch.where(mine, ids - lo, torch.zeros_like(ids)).reshape(-1)
    xs = x_local.repeat_interleave(k, dim=0)[:, None, :]                 # [T*k, 1, D]
    outs = expert_ffn(p_local["experts"], xs, lut)[:, 0]                 # [T*k, D]
    w_eff = weights.float() * mine
    y = (outs.float().reshape(t, k, -1) * w_eff[..., None]).sum(dim=1).to(x_local.dtype)
    return _add_shared(p_local, mcfg, x_local, y, mesh.get_group(ep_axis))


def moe_forward(p: Params, mcfg: MoEConfig, x: torch.Tensor, impl: str = "dense",
                routing: Optional[Routing] = None, mesh=None,
                ep_axis: str = "model") -> Tuple[torch.Tensor, Aux]:
    """The MoE half over x [B, S, D] -> ([B, S, D], aux) with a capacity:
    the training forward's (``dense``, ``sorted``) and the sharded
    prefill's (``epsum`` on ``mesh``, :func:`moe_epsum_local`). ``epsum``
    falls back to ``sorted`` without a mesh, as in the reference."""
    b, s, d = x.shape
    if impl == "dense":
        return moe_dense(p, mcfg, x, routing)
    if impl == "epsum" and mesh is not None:
        y, aux = moe_epsum_local(p, mcfg, x.reshape(-1, d), mesh=mesh, ep_axis=ep_axis)
        return y.reshape(b, s, d), aux
    if impl in ("sorted", "epsum"):
        y, aux = moe_sorted(p, mcfg, x.reshape(-1, d), routing=routing)
        return y.reshape(b, s, d), aux
    raise ValueError(f"unknown moe impl {impl!r}")
