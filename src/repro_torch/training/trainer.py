"""Train step and loop (the reference's ``training/trainer.py``).

``make_train_step`` returns ``train_step(state, tokens, labels, frontend=None)``:
the gradients of ``lm_loss`` by autograd, then one in-place AdamW update.
With ``num_micro > 1`` the batch [B, S] is split into ``num_micro`` row
blocks, each block's gradients accumulated in f32 (divided by
``num_micro``), so activations are held for B / num_micro rows at a time.

Cross-pod compression (``pod_compression=True``, the reference's
``compute_grads_pod_compressed``): ``rt.mesh`` has a "pod" axis and every
rank of it runs the step on its own pod's rows (``tokens`` is this pod's
batch slice); the gradients are reduced over "pod" by
``compression.compressed_psum_pod`` (int8 with error feedback, the
residual ``state["ef"]`` made by ``init_train_state`` under
``grad_compression="int8_ef"``); the loss is the pods' mean; AdamW runs on
every rank on the same reduced gradients, so the pods' parameters stay
equal bit for bit. The rest of the reference's distributed training (data
and tensor parallelism inside a pod, ZeRO-1, FSDP) is not ported: a mesh
axis other than "pod" longer than 1 raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ModelConfig, RunConfig, ShardingConfig
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.models.transformer import Runtime, lm_loss
from repro_torch.training import compression
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.tree import leaves

TrainState = Dict[str, Any]


def init_train_state(cfg: ModelConfig, params: Any,
                     sharding_cfg: Optional[ShardingConfig] = None) -> TrainState:
    """``{"params", "opt"}``: the parameters (marked to take gradients) and
    AdamW's state beside them; under ``grad_compression="int8_ef"`` also
    ``"ef"``, this rank's slice [1, *shape] of the reference's [pod_count,
    *shape] bf16 residual (zeros: every pod holds its own)."""
    for p in leaves(params):
        p.requires_grad_(True)
    state: TrainState = {"params": params, "opt": adamw_init(params)}
    if sharding_cfg is not None and sharding_cfg.grad_compression == "int8_ef":
        state["ef"] = compression.ef_init(params, 1)
    return state


def _pod_group(rt: Runtime, pod_count: int):
    """The "pod" process group of ``rt.mesh``; raises (before anything is
    built) without a "pod" axis of ``pod_count`` ranks, or with another axis
    longer than 1."""
    if rt.mesh is None or "pod" not in (rt.mesh.mesh_dim_names or ()):
        raise ValueError("pod_compression needs rt.mesh with a 'pod' axis "
                         "(launch.mesh.make_mesh((pods,), ('pod',)))")
    sizes = axis_sizes(rt.mesh)
    if sizes["pod"] != pod_count:
        raise ValueError(f"pod_count {pod_count} != the mesh's 'pod' axis {sizes['pod']}")
    other = {a: n for a, n in sizes.items() if a != "pod" and n > 1}
    if other:
        raise ValueError(f"pod compression over a mesh with {other}: data and tensor "
                         f"parallelism inside a pod are not ported")
    return rt.mesh.get_group("pod")


def make_train_step(cfg: ModelConfig, rt: Runtime, run: RunConfig, *, num_micro: int = 1,
                    pod_compression: bool = False, pod_count: int = 2) -> Callable:
    """Returns ``train_step(state, tokens, labels, frontend=None) -> (state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors;
    ``state`` is updated in place. Gradients travel as a list in
    ``tree.leaves`` order, the order ``adamw_update`` walks the parameters.
    ``pod_compression``: the cross-pod int8 reduction over ``rt.mesh``'s
    "pod" axis of ``pod_count`` ranks (a state with ``"ef"``), each rank
    given its pod's rows."""
    if rt.mesh is not None and not pod_compression:
        raise ValueError("training over a mesh is the cross-pod step (pod_compression=True); "
                         "plain data and tensor parallelism are not ported")
    pod_group = _pod_group(rt, pod_count) if pod_compression else None

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
        if pod_group is not None and "ef" in state:
            grads, state["ef"] = compression.compressed_psum_pod(grads, state["ef"], pod_group,
                                                                 pod_count)
            dist.all_reduce(loss, group=pod_group)
            loss = loss / pod_count
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
