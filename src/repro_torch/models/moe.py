"""Mixture-of-Experts FFN for the engine path: router, top-k, routed experts
through the slot LUT, shared experts.

The counterpart of ``repro/models/moe.py``'s ``router_logits``, ``topk_route``
and ``moe_apply_routed``. Routing runs the top-k gate kernel (K3). The
routed experts run the slot-LUT grouped matmul (K1) three times (gate, up,
down) around the SwiGLU gate, as the reference's ``moe_slot_ffn`` does,
instead of gathering a [T, k, D, F] weight copy per token as
``moe_apply_routed`` does — at a 512-token prompt with top-8 that gather is
about 13 GB per weight tensor. Two groupings feed K1:

* few tokens (decode): every (token, pick) is its own group with C = 1, its
  LUT entry the pick's slot — no host round trip;
* many tokens (prefill): picks are grouped by slot, as ``sorted_dispatch``
  does, so each resident slot is read once per layer; this needs the group
  sizes on the host, one sync per call.

Misses keep the reference's sentinel: a routed expert whose LUT entry is
``num_slots`` reads the zero MISS slot and its weight is dropped; the
engine corrects it on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, gelu

PER_PICK_MAX = 64     # up to this many (token, pick) pairs: one group each


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
    (the reference's ``moe_slot_ffn``: three K1 calls + the gate)."""
    if "w_gate" in src:
        h = F.silu(ops.slot_gmm(xs, src["w_gate"], lut)) * ops.slot_gmm(xs, src["w_up"], lut)
    else:
        h = gelu(ops.slot_gmm(xs, src["w_up"], lut))
    return ops.slot_gmm(h, src["w_down"], lut)


def moe_apply_routed(
    p: Params,
    x2d: torch.Tensor,                    # [T, D]
    ids: torch.Tensor,                    # [T, k] int (precomputed routing)
    weights: torch.Tensor,                # [T, k] f32
    *,
    slot_buffer: Optional[Params] = None,
    lut: Optional[torch.Tensor] = None,   # [E] int: expert -> slot, num_slots = MISS
    include_shared: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply already-routed experts. Returns (y [T, D], miss [T, k] bool)."""
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
        outs = _grouped(src, x2d, gidx, miss, num_slots)           # [T*k, D]
    y = (outs.float().reshape(t, k, -1) * w_eff[..., None]).sum(dim=1).to(x2d.dtype)
    if include_shared and "shared" in p:
        y = y + shared_ffn(p, x2d)
    return y, miss


def _grouped(src: Params, x2d: torch.Tensor, gidx: torch.Tensor, miss: torch.Tensor,
             miss_slot: Optional[int]) -> torch.Tensor:
    """Picks grouped by slot into K1's [G, C, D] form (C = the largest group,
    shorter groups zero-padded); missed picks are left out (their weight is
    dropped anyway). Returns the per-pick outputs [T*k, D] in pick order."""
    t, k = gidx.shape
    d = x2d.shape[1]
    flat = gidx.reshape(-1)
    keep = ~miss.reshape(-1)
    n_store = int(src["w_up"].shape[0])
    counts = torch.bincount(flat[keep], minlength=n_store)
    counts_h = counts.cpu()                                      # the one sync
    if miss_slot is not None:
        counts_h[miss_slot] = 0
    used = torch.nonzero(counts_h > 0).flatten()
    out = torch.zeros((t * k, d), dtype=x2d.dtype, device=x2d.device)
    if used.numel() == 0:
        return out
    c_max = int(counts_h.max())
    group_of = torch.full((n_store,), -1, dtype=torch.long)
    group_of[used] = torch.arange(used.numel())
    group_of = group_of.to(x2d.device)
    pick = torch.nonzero(keep).flatten()                         # kept picks
    order = pick[torch.argsort(flat[pick], stable=True)]
    slot_sorted = flat[order]
    starts = torch.cumsum(counts, 0) - counts                   # first row per slot
    pos = torch.arange(order.numel(), device=x2d.device) - starts[slot_sorted]
    grp = group_of[slot_sorted]
    xs = torch.zeros((used.numel(), c_max, d), dtype=x2d.dtype, device=x2d.device)
    xs[grp, pos] = x2d[order // k]
    ys = expert_ffn(src, xs, used.to(device=x2d.device, dtype=torch.int32))
    out[order] = ys[grp, pos]
    return out
