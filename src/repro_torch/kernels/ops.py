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
    "decode_attention": _dec.KERNEL,
    "topk_gate": _tk.KERNEL,
    "flash_attention": _fa.KERNEL,
}


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def slot_gmm(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """x [G, C, D] @ w[lut[g]] -> [G, C, F] (f32 accumulation, x's type)."""
    if _on_card(x):
        return _gmm.slot_gmm(x, w, lut)
    return ref.slot_gmm_ref(x, w, lut)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    cur_len: int, soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Adapter for the model's decode path: q [B, 1, H, dh], cache k/v
    [B, S, Hkv, dh]. ``cur_len`` counts the tokens BEFORE this one; the new
    token's KV is already written, so each row's valid length is cur_len + 1.
    Sliding windows stay in the caller's plain path (ring masks)."""
    b = q.shape[0]
    lengths = torch.full((b,), cur_len + 1, dtype=torch.int32, device=q.device)
    if _on_card(q):
        out = _dec.decode_attention(q[:, 0], k, v, lengths, soft_cap=soft_cap)
    else:
        out = ref.decode_attention_ref(q[:, 0], k, v, lengths, soft_cap=soft_cap)
    return out[:, None]


def topk_gate(
    logits: torch.Tensor, k: int, *, normalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_card(logits):
        return _tk.topk_gate(logits, k, normalize=normalize)
    return ref.topk_gate_ref(logits, k, normalize=normalize)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window, soft_cap=soft_cap)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, soft_cap=soft_cap)
