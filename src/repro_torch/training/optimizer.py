"""AdamW with a warmup + cosine schedule and global-norm clipping (the
reference's ``training/optimizer.py``).

Moments are f32 whatever the parameters' type; the update runs in f32 and
casts back. Bias correction counts the step being taken (``step + 1``).
Parameters and moments are updated IN PLACE (at full width the state is
most of the card: a copy would not fit beside it) and returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.config.base import RunConfig
from repro_torch.tree import leaves, map_tree

OptState = Dict[str, Any]


def lr_at(run: RunConfig, step: Any) -> float:
    """Linear warmup over ``warmup_steps``, then a cosine from the peak down
    to 10% of it at ``total_steps``."""
    step = float(step)
    warm = min(step / max(run.warmup_steps, 1), 1.0)
    prog = min(max((step - run.warmup_steps) / max(run.total_steps - run.warmup_steps, 1),
                   0.0), 1.0)
    return run.learning_rate * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def adamw_init(params: Any) -> OptState:
    """f32 zero moments beside every parameter, and the step count (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params), "step": step}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt: OptState,
                 run: RunConfig) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: gradients scaled by ``min(1, grad_clip / (norm +
    1e-9))``, decoupled weight decay on every parameter. Returns (params,
    opt, {grad_norm, lr}), both updated in place."""
    gnorm = global_norm(grads)
    lr = adamw_apply(leaves(params), leaves(grads), leaves(opt["m"]), leaves(opt["v"]),
                     opt, run, gnorm)
    return params, opt, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_apply(ps: List[torch.Tensor], gs: List[torch.Tensor], ms: List[torch.Tensor],
                vs: List[torch.Tensor], opt: OptState, run: RunConfig,
                gnorm: torch.Tensor) -> torch.Tensor:
    """AdamW's arithmetic on parallel lists of parameters (or views of
    their shards), gradients and moments, given the global gradient norm;
    each ``p`` written in place, the step count advanced. Returns the
    learning rate (a 0-d f32 tensor). ZeRO-1 runs it on a rank's shards."""
    step = int(opt["step"]) + 1
    scale = torch.clamp(run.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(run, step)
    b1, b2 = run.beta1, run.beta2
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g.float() * scale                  # a new f32 temporary, reused in
        m.mul_(b1).add_(g, alpha=1 - b1)       # place: the update is memory-bound
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = torch.div(v, bc2, out=g).sqrt_().add_(1e-8)
        delta = torch.div(m, bc1).div_(delta)
        p32 = p.float()
        p.copy_(p32.sub_(delta.add_(p32, alpha=run.weight_decay), alpha=lr))
    opt["step"].fill_(step)
    return torch.tensor(lr, dtype=torch.float32)
