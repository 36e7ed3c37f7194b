"""Decoder assembly for the engine path: init, per-layer KV state, the decode
step over the layer stack, and the lm head.

The counterpart of ``repro/models/transformer.py`` for MoE stacks of
``attn_moe`` blocks. Parameters are plain dicts of tensors: ``embed``,
``final_norm``, ``lm_head`` and ``layers``, a list with one dict per layer
(the reference stacks repeated layers for its ``lax.scan``; a Python loop
over layers needs no stacking). The KV state is a list of per-layer
``{"k", "v"}`` caches that decode updates in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import Params, apply_norm, embed_init, init_norm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclass(frozen=True)
class Runtime:
    """Execution context: the KV cache capacity decode runs against."""

    cache_len: int = 2048


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
    layers: List[Params] = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "attn": attn.init_attention(gen, cfg.d_model, cfg.attention, dtype, device),
            "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device),
            "moe": moe_mod.init_moe(gen, cfg.d_model, cfg.moe, cfg.mlp, dtype, device,
                                    expert_device=expert_device),
        })
    p: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "layers": layers,
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return p


def zero_state(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> List[Dict[str, torch.Tensor]]:
    dtype = torch_dtype(cfg)
    return [attn.zero_cache(cfg.attention, batch, cache_len, dtype, device)
            for _ in range(cfg.num_layers)]


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def lm_logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg.norm, params["final_norm"], h)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def attn_half(cfg: ModelConfig, p: Params, x: torch.Tensor, mode: str, state: Any,
              cur_len: int, cache_len: int) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Attention + residual, then the MoE input norm: (x_mid, h2 [T, D], state).
    ``prefill`` returns a fresh cache; ``decode`` updates ``state`` in place."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    if mode == "prefill":
        y, state = attn.attention_prefill(p["attn"], cfg.attention, h, cache_len)
    elif mode == "decode":
        y = attn.attention_decode(p["attn"], cfg.attention, h, state, cur_len)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x_mid = x + y
    h2 = apply_norm(cfg.norm, p["ln2"], x_mid).reshape(-1, x.shape[-1])
    return x_mid, h2, state


def decode_model(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,              # [B] current token
    state: List[Dict[str, torch.Tensor]],
    cur_len: int,                     # tokens already in the cache
    residency: Optional[List[Tuple[Params, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over every layer: returns (logits [B, V], aux).

    ``residency`` gives each layer's (slot buffers, device LUT); None reads
    the full expert store in ``params``. ``state`` is updated in place. aux
    holds the routing telemetry stacked over layers: ``route_ids`` /
    ``route_weights`` / ``route_miss`` [L, T, k], ``route_h`` [L, T, D] (the
    MoE inputs the demand GEMM reads) and ``route_x`` [L, T, D] (each block's
    input, the replay anchor)."""
    x = embed_tokens(params, token[:, None])
    b, _, d = x.shape
    tel: Dict[str, List[torch.Tensor]] = {n: [] for n in ("ids", "weights", "miss", "h", "x")}
    for li, p in enumerate(params["layers"]):
        tel["x"].append(x.reshape(-1, d))
        x_mid, h2, _ = attn_half(cfg, p, x, "decode", state[li], cur_len, 0)
        logits = moe_mod.router_logits(p["moe"], h2)
        ids, weights = moe_mod.topk_route(logits, cfg.moe)
        slots, lut = residency[li] if residency is not None else (None, None)
        y2, miss = moe_mod.moe_apply_routed(p["moe"], h2, ids, weights,
                                            slot_buffer=slots, lut=lut)
        x = x_mid + y2.reshape(x_mid.shape)
        for n, v in (("ids", ids), ("weights", weights), ("miss", miss), ("h", h2)):
            tel[n].append(v)
    logits = lm_logits(cfg, params, x[:, -1:])[:, 0]
    aux = {f"route_{n}": torch.stack(v) for n, v in tel.items()}
    return logits, aux
