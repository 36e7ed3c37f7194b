"""Weight bridge: the reference's parameter tree (as numpy) -> the port's.

The JAX package stacks repeated layers along a leading axis (one segment per
``(unit, reps)`` of ``cfg.segments``); the port keeps one dict per layer.
:func:`from_reference` walks the segments in stack order and slices each
rep, so both packages run the same weights. bf16 arrays arrive as numpy's
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: they are viewed
as uint16 and reinterpreted as ``torch.bfloat16``, bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config.base import ModelConfig


def to_tensor(a: Any, device="cpu") -> torch.Tensor:
    """One numpy array (any of the reference's dtypes) -> a torch tensor."""
    a = np.array(a, copy=True, order="C")          # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_reference(cfg: ModelConfig, params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """``repro.models.init_params`` output with every leaf as numpy -> the
    port's ``{"embed", "layers": [...], "final_norm", "lm_head"}``."""
    layers = []
    for si, (unit, reps) in enumerate(cfg.segments):
        for r in range(reps):
            for pi, _kind in enumerate(unit):
                stacked = params["segments"][si][pi]
                layers.append(_map(stacked, lambda a, r=r: to_tensor(np.asarray(a)[r], device)))
    out = {"embed": to_tensor(params["embed"], device), "layers": layers,
           "final_norm": _map(params["final_norm"], lambda a: to_tensor(a, device))}
    if "lm_head" in params:
        out["lm_head"] = to_tensor(params["lm_head"], device)
    return out
