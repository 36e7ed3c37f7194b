"""Train step and loop on one device (the reference's ``training/trainer.py``).

``make_train_step`` returns ``train_step(state, tokens, labels, frontend=None)``:
the gradients of ``lm_loss`` by autograd, then one in-place AdamW update.
With ``num_micro > 1`` the global batch [B, S] is split into ``num_micro``
row blocks, each block's gradients accumulated in f32 (divided by
``num_micro``), so activations are held for B / num_micro rows at a time.
The reference's cross-pod int8 gradient compression with error feedback
(``grad_compression="int8_ef"``, ``pod_compression``) belongs to the
distributed slice, which is not ported: asking for it raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig, RunConfig, ShardingConfig
from repro_torch.models.transformer import Runtime, lm_loss
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.tree import leaves

TrainState = Dict[str, Any]

_DISTRIBUTED = ("the cross-pod int8 gradient compression belongs to the distributed slice "
                "(distributed/, checkpoint/elastic.py, launch/mesh.py), not ported yet")


def init_train_state(cfg: ModelConfig, params: Any,
                     sharding_cfg: Optional[ShardingConfig] = None) -> TrainState:
    """``{"params", "opt"}``: the parameters (marked to take gradients) and
    AdamW's state beside them."""
    if sharding_cfg is not None and sharding_cfg.grad_compression == "int8_ef":
        raise NotImplementedError(_DISTRIBUTED)
    for p in leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw_init(params)}


def make_train_step(cfg: ModelConfig, rt: Runtime, run: RunConfig, *, num_micro: int = 1,
                    pod_compression: bool = False) -> Callable:
    """Returns ``train_step(state, tokens, labels, frontend=None) -> (state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors;
    ``state`` is updated in place. Gradients travel as a list in
    ``tree.leaves`` order, the order ``adamw_update`` walks the parameters."""
    if pod_compression:
        raise NotImplementedError(_DISTRIBUTED)

    def grads_of(params, tokens, labels, frontend):
        loss, _ = lm_loss(cfg, params, tokens, labels, rt, frontend)
        return loss.detach(), torch.autograd.grad(loss, leaves(params))

    def compute_grads(params, tokens, labels, frontend):
        if num_micro <= 1:
            return grads_of(params, tokens, labels, frontend)
        mb = tokens.shape[0] // num_micro
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(num_micro):
            rows = slice(i * mb, (i + 1) * mb)
            loss, grads = grads_of(params, tokens[rows], labels[rows],
                                   None if frontend is None else frontend[rows])
            for a, g in zip(acc, grads):
                a.add_(g.float() / num_micro)
            loss_sum = loss_sum + loss / num_micro
        return loss_sum, acc

    def train_step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor,
                   frontend: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict]:
        params = state["params"]
        loss, grads = compute_grads(params, tokens, labels, frontend)
        _, _, metrics = adamw_update(params, grads, state["opt"], run)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def train_loop(cfg: ModelConfig, state: TrainState, step_fn: Callable, loader, run: RunConfig,
               *, num_steps: int, ckpt_manager=None,
               log: Optional[Callable[[int, Dict], None]] = None) -> Tuple[TrainState, Dict]:
    """``num_steps`` steps from ``loader`` (which yields (step, tokens,
    labels)); logs every ``run.log_every`` steps and saves every
    ``run.checkpoint_every`` (the checkpoint is named by the steps done)."""
    last: Dict[str, float] = {}
    for _ in range(num_steps):
        step, tokens, labels = next(loader)
        state, metrics = step_fn(state, tokens, labels)
        last = {k: float(v) for k, v in metrics.items()}
        if log is not None and step % run.log_every == 0:
            log(step, last)
        if ckpt_manager is not None and (step + 1) % run.checkpoint_every == 0:
            ckpt_manager.save(step + 1, state)
    return state, last
