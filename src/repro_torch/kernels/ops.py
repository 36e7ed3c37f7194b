"""Dispatch between the CUDA kernels and their plain versions.

The counterpart of ``repro/kernels/ops.py``. A tensor on the CPU goes to the
plain PyTorch version in ``kernels/ref.py`` (that is what the CPU tests run);
a CUDA tensor launches the hand-written kernel, which either runs or raises;
any other device raises. Nothing falls back from the card to the plain path.

Model code calls these wrappers and never the kernels directly. Each kernel
counts its launches (``launch_counts``), so a run can show that its main
path went through the kernels; the plain path counts nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import topk_gate as _tk

KERNELS = {
    "slot_gmm": _gmm.KERNEL,
    "slot_gmm_tiled": _gmm.TILED,
    "slot_gmm_int8": _gmm.INT8,
    "slot_gmm_int8_tiled": _gmm.INT8_TILED,
    "slot_gmm_int4": _gmm.INT4,
    "slot_gmm_int4_tiled": _gmm.INT4_TILED,
    "decode_attention": _dec.KERNEL,
    "topk_gate": _tk.KERNEL,
    "flash_attention": _fa.KERNEL,
    "flash_attention_chunk": _fa.CHUNK,
}


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def symbol_launch_counts() -> Dict[str, Dict[str, int]]:
    """Launches per kernel and launcher symbol (an entry of a kernel that
    has several, such as K3's ``topk_gate_f32`` and ``router_topk_*``)."""
    return {name: dict(k.symbol_launches) for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()


def launches_since(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """Launches per kernel and symbol counted since ``before`` (an earlier
    ``symbol_launch_counts()``), zero entries left out."""
    out: Dict[str, Dict[str, int]] = {}
    for name, syms in symbol_launch_counts().items():
        delta = {s: n - before.get(name, {}).get(s, 0) for s, n in syms.items()}
        delta = {s: n for s, n in delta.items() if n}
        if delta:
            out[name] = delta
    return out


def add_launches(delta: Dict[str, Dict[str, int]], times: int = 1) -> None:
    """Count ``times`` x ``delta`` (kernel -> symbol -> launches). A CUDA
    graph's replay launches what its capture recorded without passing the
    wrappers, so its owner counts the capture's launches this way: once
    negated after the capture (which launched nothing), then once per
    replay."""
    for name, syms in delta.items():
        for sym, n in syms.items():
            KERNELS[name].count(sym, n * times)


def slot_gmm(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
             scale: Optional[torch.Tensor] = None,
             mn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [G, C, D] @ w[lut[g]] -> [G, C, F], f32 accumulation: x's type for
    bf16/f32 slots, f32 for int8 (``scale``) and int4 (``scale``, ``mn``)."""
    if _on_card(x):
        return _gmm.slot_gmm(x, w, lut, scale, mn)
    return ref.slot_gmm_ref(x, w, lut, scale, mn)


def slot_gmm_ragged(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    mn: Optional[torch.Tensor] = None, *,
                    miss_slot: Optional[int] = None) -> torch.Tensor:
    """x [N, D] rows sorted by slot, ``offsets`` [S1+1] int32 (slot s owns
    rows ``offsets[s] .. offsets[s+1]``; ``miss_slot``'s rows give zeros)
    -> [N, F], the types of :func:`slot_gmm`. On the card, K1's ragged
    entry (no host round trip), counted under the format's tiled body."""
    if _on_card(x):
        return _gmm.slot_gmm_ragged(x, w, offsets, scale, mn, miss_slot=miss_slot)
    return ref.slot_gmm_ragged_ref(x, w, offsets, scale, mn, miss_slot=miss_slot)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    lengths: torch.Tensor, soft_cap: Optional[float] = None,
    page_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Adapter for the model's decode path: q [B, 1, H, dh], cache k/v
    [B, S, Hkv, dh], ``lengths`` [B] int on q's device: each row's valid
    positions (the new token's KV already written; a length past S scores
    all S, a full ring cache). The lengths stay on the device, so a CUDA
    graph can capture the call with the host setting them before a replay
    (the reference's adapter takes ``cur_len``, scalar or [B], and adds 1).

    ``page_table`` [B, n_pages] int32: k/v are the serving pool's shared
    planes [P, ps, Hkv, dh] and each row's cache is its pages; on the card
    K2's paged entry reads them through the table, with no gathered copy."""
    if page_table is not None:
        if _on_card(q):
            out = _dec.decode_attention_paged(q[:, 0], k, v, page_table, lengths,
                                              soft_cap=soft_cap)
        else:
            out = ref.decode_attention_paged_ref(q[:, 0], k, v, page_table, lengths,
                                                 soft_cap=soft_cap)
        return out[:, None]
    if _on_card(q):
        out = _dec.decode_attention(q[:, 0], k, v, lengths, soft_cap=soft_cap)
    else:
        out = ref.decode_attention_ref(q[:, 0], k, v, lengths, soft_cap=soft_cap)
    return out[:, None]


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             lengths: torch.Tensor,
                             soft_cap: Optional[float] = None) -> torch.Tensor:
    """One slice of a cache split by sequence: q [B, H, dh] (every query
    head) against the slice k/v [B, S_loc, Hkv, dh] at local ``lengths``
    [B] (0 .. S_loc, on q's device) -> f32 [B, H, dh + 1], each head's
    normalized context, then its log-sum-exp (``-inf`` where the slice is
    empty). On the card, K2's partial entry."""
    if _on_card(q):
        return _dec.decode_attention_partial(q, k, v, lengths, soft_cap=soft_cap)
    return ref.decode_attention_partial_ref(q, k, v, lengths, soft_cap=soft_cap)


def topk_gate(
    logits: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits [T, E] -> (ids int32 [T, k], weights f32 [T, k]): K3's
    logits-in entry, the counterpart of the Pallas ``topk_gate``."""
    if _on_card(logits):
        return _tk.topk_gate(logits, k, normalize=normalize)
    return ref.topk_gate_ref(logits, k, normalize=normalize)


def router_topk(
    h2: torch.Tensor, router: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_gate(h2.float() @ router, k)`` in one call: h2 [T, D] bf16 or
    f32, router f32 [D, E]. On the card, K3's fused entry (one launch, the
    logits never leave the SMs); on the CPU, the plain router GEMM and gate."""
    if _on_card(h2):
        return _tk.router_topk(h2, router, k, normalize=normalize)
    return ref.router_topk_ref(h2, router, k, normalize=normalize)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window, soft_cap=soft_cap)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, soft_cap=soft_cap)


def flash_attention_chunk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len: torch.Tensor, *,
    window: Optional[int] = None, soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """A prefill chunk's causal attention: q [B, C, H, dh] at positions
    ``cur_len ..`` against the cache k/v [B, cap, Hkv, dh] holding position
    i at slot i, the chunk's KV already written. ``cur_len`` is an int64
    scalar on q's device (K4's chunk-append entry reads it there)."""
    if _on_card(q):
        return _fa.flash_attention_chunk(q, k, v, cur_len, window=window, soft_cap=soft_cap)
    return ref.flash_attention_chunk_ref(q, k, v, cur_len, window=window, soft_cap=soft_cap)


def flash_attention_chunk_partial(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len: torch.Tensor, offset: int, *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """One slice of a chunk's causal attention over a cache split by
    sequence: q [B, C, H, dh] at positions ``cur_len ..`` (an int64 scalar
    on q's device) against the slice k/v [B, S_loc, Hkv, dh] that holds
    positions ``offset ..`` -> f32 [B, C, H, dh + 1], each head's normalized
    context, then its log-sum-exp (``-inf`` where no key of the slice is
    visible), merged over the slices by ``parallel.merge_partials``. On the
    card, K4's partial chunk entry."""
    if _on_card(q):
        return _fa.flash_attention_chunk_partial(q, k, v, cur_len, offset, soft_cap=soft_cap)
    return ref.flash_attention_chunk_partial_ref(q, k, v, cur_len, offset, soft_cap=soft_cap)
