"""int8 gradient compression with error feedback for the cross-pod reduction
(the reference's ``training/compression.py``).

On a multi-pod mesh the links between pods are the slow ones. Each pod rank
computes gradients on its own batch slice and the reduction over "pod"
happens here, int8 on the wire:

  residual-corrected g -> one scale per tensor (all_reduce MAX, so every pod
  agrees) -> int8 quantization -> **all_reduce SUM over "pod"** (as int32,
  so the sum cannot overflow) -> dequantized mean -> new residual.

Error feedback keeps the quantizer unbiased over steps: what a step did not
send is added to the next step's gradient. The arithmetic follows the
reference's order of operations in f32 (``torch.round`` rounds half to
even, as ``jnp.round``), so the int8 payload is the reference's.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, map_tree, replace_leaves


def ef_init(params: Any, pod_count: int = 2) -> Any:
    """The error-feedback state [pod_count, *shape] bf16 zeros per leaf (the
    reference's layout; a rank of a pod holds its own [1, *shape] slice)."""
    return map_tree(lambda p: torch.zeros((pod_count,) + tuple(p.shape), dtype=torch.bfloat16,
                                          device=p.device), params)


def quantize(gf: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, scale) of the f32 gradient ``gf`` under the pods'
    shared ``amax``: ``scale = amax / 127 + 1e-12``, ``q = clip(round(gf /
    scale), -127, 127)``."""
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_pod(grads: Sequence[torch.Tensor], ef: Any, group=None,
                        pod_count: int = 2) -> Tuple[List[torch.Tensor], Any]:
    """``grads`` (a sequence of tensors, ``tree.leaves`` order of ``ef``)
    and this pod's residual slice ``ef`` ([1, *shape] bf16 per leaf) ->
    (the pods' mean gradients, each in its gradient's type; the new ``ef``
    slice). ``group`` is the "pod" process group (None: the whole world).
    The per-tensor maxima travel in one ``all_reduce`` (a max is exact in
    any grouping), each payload in its own."""
    flat_e = leaves(ef)
    if len(flat_e) != len(grads):
        raise ValueError(f"{len(grads)} gradients for {len(flat_e)} residuals")

    def corrected(g, e):                       # the residual-corrected f32 gradient
        return g.float() + e[0].float()

    # the maxima first (each corrected gradient made again below, so no
    # second f32 copy of every gradient is held at once)
    amax = torch.stack([corrected(g, e).abs().max() for g, e in zip(grads, flat_e)])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    outs, new_e = [], []
    for g, e, a in zip(grads, flat_e, amax):
        gf = corrected(g, e)
        q, scale = quantize(gf, a)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        outs.append(((summed.float() * scale) / pod_count).to(g.dtype))
        new_e.append((gf - q.float() * scale)[None].to(torch.bfloat16))
    return outs, replace_leaves(ef, new_e)
