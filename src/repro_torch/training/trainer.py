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
equal bit for bit. Data or tensor axes inside a pod raise.

Data parallelism with ZeRO-1 (``rt.mesh`` with data axes and a tensor axis
of 1; the reference's ``train_cell`` under GSPMD, whose semantics are those
of the global arrays). ``tokens`` / ``labels`` are this data rank's rows
(:func:`data_rows`): the reference reshapes the global batch [B, S] to
[num_micro, B / num_micro, S], and under its mesh each microbatch's MoE
half runs in a ``shard_map`` with ``in_specs`` ``P(dp, None)``, so data
rank r holds rows ``i mb + [r mb / dp, (r + 1) mb / dp)`` of microbatch i
(mb = B / num_micro), and its sorted dispatch keeps a per-data-shard
capacity over those rows (checked against a JAX run of ``make_train_step``
over a (data 2) mesh, ``tests/test_torch_data_parallel.py``). Each rank's
loss is its share of the reference's: its label sum over each microbatch's
global count of valid labels (the counts all-reduced once, before the
forward) plus the MoE terms over the data ranks, so the gradients are
SUMMED over the data axes. The reference's MoE terms leave that
``shard_map`` through ``out_specs`` ``P()`` unchecked: their gradient is
the mean over the shards (reproduced here), their value one shard's (the
port reports the mean; ``metrics["lm_xent"]`` is the cross-entropy part
alone). Under ZeRO-1 (``rt.sharding.zero1``) each moment is stored at its
``opt_spec`` shard (the data axes on the first free dimension that
divides; :func:`zero1_dims`), that leaf's gradient reduce-scattered along
it, every other leaf's all-reduced; AdamW's arithmetic runs on the shards
and the parameters are all-gathered after it. The gradient norm sums each
leaf's squares over its ZeRO-1 shards in rank order (a replicated leaf
once) whether or not the moments are sharded, so ZeRO-1 on and off take
the same steps. A tensor axis longer than 1 raises (the model axis in
training is a later slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ModelConfig, RunConfig, ShardingConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import _dp_entry, axis_sizes, make_train_state_shardings
from repro_torch.models.transformer import Runtime, loss_targets, lm_loss
from repro_torch.training import compression
from repro_torch.training.optimizer import adamw_apply, adamw_init, adamw_update
from repro_torch.tree import items, leaves, replace_leaves

TrainState = Dict[str, Any]


def init_train_state(cfg: ModelConfig, params: Any,
                     sharding_cfg: Optional[ShardingConfig] = None, *,
                     mesh: Any = None) -> TrainState:
    """``{"params", "opt"}``: the parameters (marked to take gradients) and
    AdamW's state beside them; under ``grad_compression="int8_ef"`` also
    ``"ef"``, this rank's slice [1, *shape] of the reference's [pod_count,
    *shape] bf16 residual (zeros: every pod holds its own). With ``mesh``
    (data parallelism) and ``sharding_cfg.zero1``, each moment is this
    rank's ``opt_spec`` shard (:func:`zero1_dims`)."""
    for p in leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params)
    if mesh is not None and sharding_cfg is not None and sharding_cfg.zero1:
        dims = zero1_dims(cfg, params, mesh, sharding_cfg)
        dp = _dp_size(mesh, sharding_cfg)
        for key in ("m", "v"):
            opt[key] = replace_leaves(opt[key], [
                m if d is None else torch.zeros(_shard_shape(m.shape, d, dp),
                                                dtype=m.dtype, device=m.device)
                for m, d in zip(leaves(opt[key]), dims)])
    state: TrainState = {"params": params, "opt": opt}
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


def _dp_size(mesh, sh: ShardingConfig) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in sh.dp_axes:
        n *= sizes.get(a, 1)
    return n


def _shard_shape(shape, dim: int, parts: int) -> Tuple[int, ...]:
    return tuple(n // parts if i == dim else n for i, n in enumerate(shape))


def zero1_dims(cfg: ModelConfig, params: Any, mesh, sh: ShardingConfig) -> List[Optional[int]]:
    """Per parameter leaf (``tree.leaves`` order), the dimension its ZeRO-1
    moments split over the data axes (``opt_spec`` with ``zero1``,
    sanitized for ``mesh``), or None (replicated)."""
    state = {"opt": {"m": params}}
    specs = make_train_state_shardings(cfg, mesh, dataclasses.replace(sh, zero1=True), state)
    dp = _dp_entry(sh)
    out = []
    for path, _ in items(params):
        spec = specs[f"opt/m/{path}"]
        out.append(next((i for i, e in enumerate(spec) if e == dp), None))
    return out


def data_rows(tokens: torch.Tensor, num_micro: int, rank: int, dp: int) -> torch.Tensor:
    """Data rank ``rank``'s rows of a global batch [B, ...] (of ``dp`` data
    ranks): rows ``i mb + [rank mb / dp, (rank + 1) mb / dp)`` of each of
    the ``num_micro`` microbatches (mb = B / num_micro), in microbatch
    order: what the reference's ``shard_map`` gives data shard ``rank``."""
    n = max(num_micro, 1)
    mb = tokens.shape[0] // n
    share = mb // dp
    if tokens.shape[0] % n or mb % dp:
        raise ValueError(f"a batch of {tokens.shape[0]} does not split into {n} microbatches "
                         f"over {dp} data ranks")
    return torch.cat([tokens[i * mb + rank * share:i * mb + (rank + 1) * share]
                      for i in range(n)])


class _DataParallel:
    """The data axes of ``rt.mesh`` for the DP + ZeRO-1 step: one data axis
    longer than 1 (the others and the tensor axis of length 1); raises
    before anything is built otherwise."""

    def __init__(self, cfg: ModelConfig, rt: Runtime):
        sh = rt.sharding
        sizes = axis_sizes(rt.mesh)
        if sizes.get(sh.tp_axis, 1) > 1:
            raise ValueError(f"training over a tensor axis of {sizes[sh.tp_axis]} is not ported "
                             f"(the model axis in training is a later slice)")
        long = [a for a, n in sizes.items() if n > 1]
        if any(a not in sh.dp_axes for a in long) or len(long) > 1:
            raise ValueError(f"data-parallel training takes one data axis of {sh.dp_axes} "
                             f"longer than 1, the mesh has {sizes}")
        self.cfg, self.mesh, self.sh = cfg, rt.mesh, sh
        self.axis = long[0] if long else sh.dp_axes[0]
        self.size = sizes.get(self.axis, 1)
        self.rank = rt.mesh.get_local_rank(self.axis)
        self.group = rt.mesh.get_group(self.axis)
        self.dims: Optional[List[Optional[int]]] = None

    def setup(self, params: Any, opt: Dict) -> None:
        """The ZeRO-1 dimensions, once; the moments' shapes checked against them."""
        if self.dims is not None:
            return
        self.dims = zero1_dims(self.cfg, params, self.mesh, self.sh)
        for p, m, d in zip(leaves(params), leaves(opt["m"]), self.dims):
            want = (tuple(p.shape) if d is None or not self.sh.zero1
                    else _shard_shape(p.shape, d, self.size))
            if tuple(m.shape) != want:
                raise ValueError(f"a moment of shape {tuple(m.shape)} for a parameter of "
                                 f"{tuple(p.shape)}: expected {want} (init_train_state(mesh=) "
                                 f"with zero1={self.sh.zero1})")

    def shard(self, t: torch.Tensor, d: int, r: int) -> torch.Tensor:
        n = t.shape[d] // self.size
        return t.narrow(d, r * n, n)

    def reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Gradients summed over the data axis: each ZeRO-1 leaf's shard
        (reduce-scatter along its dimension) when the moments are sharded,
        else every leaf whole (all-reduce)."""
        out = []
        for g, d in zip(grads, self.dims):
            if d is not None and self.sh.zero1:
                out.append(parallel.reduce_scatter_dim(g, d, self.group, self.size))
            else:
                out.append(parallel.all_reduce_(g.contiguous(), self.group))
        return out

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm: each ZeRO-1 leaf's squares summed per
        shard (this rank's, all-gathered; or every shard of a whole reduced
        gradient) and the shards added in rank order; a replicated leaf
        once."""
        zero = [(g, d) for g, d in zip(grads, self.dims) if d is not None]
        if self.sh.zero1:
            mine = torch.stack([torch.sum(torch.square(g.float())) for g, _ in zero]) if zero \
                else torch.zeros(0, device=grads[0].device)
            per = parallel.all_gather_dim(mine[None], 0, self.group, self.size)
        else:
            per = torch.stack([torch.stack([torch.sum(torch.square(
                self.shard(g, d, r).contiguous().float())) for g, d in zero])
                for r in range(self.size)]) if zero else None
        tot, j = torch.zeros((), dtype=torch.float32, device=grads[0].device), 0
        for g, d in zip(grads, self.dims):
            if d is None:
                tot = tot + torch.sum(torch.square(g.float()))
                continue
            for r in range(self.size):
                tot = tot + per[r, j]
            j += 1
        return torch.sqrt(tot)

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor], opt: Dict,
               run: RunConfig) -> Dict[str, torch.Tensor]:
        """AdamW on this rank's shards (ZeRO-1) or on whole leaves, then the
        updated shards all-gathered into every rank's parameters."""
        gnorm = self.norm(grads)
        ps = leaves(params)
        views = [self.shard(p, d, self.rank) if d is not None and self.sh.zero1 else p
                 for p, d in zip(ps, self.dims)]
        lr = adamw_apply(views, grads, leaves(opt["m"]), leaves(opt["v"]), opt, run, gnorm)
        for p, v, d in zip(ps, views, self.dims):
            if v is not p:
                p.copy_(parallel.all_gather_dim(v, d, self.group, self.size))
        return {"grad_norm": gnorm, "lr": lr}

    def full_state(self, state: TrainState) -> TrainState:
        """The state in the reference's layout (every moment whole), its
        ZeRO-1 shards all-gathered: what a checkpoint saves."""
        if not self.sh.zero1 or self.dims is None:
            return state
        opt = dict(state["opt"])
        for key in ("m", "v"):
            opt[key] = replace_leaves(opt[key], [
                m if d is None else parallel.all_gather_dim(m, d, self.group, self.size)
                for m, d in zip(leaves(opt[key]), self.dims)])
        return {**state, "opt": opt}


def make_train_step(cfg: ModelConfig, rt: Runtime, run: RunConfig, *, num_micro: int = 1,
                    pod_compression: bool = False, pod_count: int = 2) -> Callable:
    """Returns ``train_step(state, tokens, labels, frontend=None) -> (state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors;
    ``state`` is updated in place. Gradients travel as a list in
    ``tree.leaves`` order, the order ``adamw_update`` walks the parameters.
    ``pod_compression``: the cross-pod int8 reduction over ``rt.mesh``'s
    "pod" axis of ``pod_count`` ranks (a state with ``"ef"``), each rank
    given its pod's rows. ``rt.mesh`` without ``pod_compression``: the
    data-parallel step (module docstring), given this data rank's rows
    (:func:`data_rows`); ``train_step.full_state(state)`` gives the state
    with its moments whole (a checkpoint's), ``train_step.writer`` is True
    on the one rank that writes it. metrics add ``lm_xent``, the
    cross-entropy part of the loss."""
    pod_group = _pod_group(rt, pod_count) if pod_compression else None
    dp = _DataParallel(cfg, rt) if rt.mesh is not None and not pod_compression else None
    if dp is not None:
        return _dp_train_step(cfg, rt, run, dp, num_micro)

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


def _dp_train_step(cfg: ModelConfig, rt: Runtime, run: RunConfig, dp: _DataParallel,
                   num_micro: int) -> Callable:
    local = dataclasses.replace(rt, mesh=None)      # the forward on this rank's rows

    def train_step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor,
                   frontend: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict]:
        params = state["params"]
        dp.setup(params, state["opt"])
        n = max(num_micro, 1)
        mb = tokens.shape[0] // n
        tgt = loss_targets(cfg, labels)
        counts = torch.stack([(tgt[i * mb:(i + 1) * mb] >= 0).sum()
                              for i in range(n)]).to(torch.float32)
        parallel.all_reduce_(counts, dp.group)       # each microbatch's global count
        grads: Optional[List[torch.Tensor]] = None
        sums = torch.zeros(2, dtype=torch.float32, device=tokens.device)   # loss, xent
        for i in range(n):
            rows = slice(i * mb, (i + 1) * mb)
            loss, aux = lm_loss(cfg, params, tokens[rows], labels[rows], local,
                                None if frontend is None else frontend[rows],
                                count=counts[i], aux_weight=1.0 / dp.size)
            g = torch.autograd.grad(loss, leaves(params))
            part = torch.stack([loss.detach(), aux["lm_xent"]]).float()
            if n == 1:
                grads, sums = list(g), part
            else:
                grads = ([gi.float() / n for gi in g] if grads is None
                         else [a.add_(gi.float() / n) for a, gi in zip(grads, g)])
                sums = sums + part / n
        parallel.all_reduce_(sums, dp.group)
        metrics = dp.update(params, dp.reduce(grads), state["opt"], run)
        metrics.update(loss=sums[0], lm_xent=sums[1])
        return state, metrics

    train_step.full_state = dp.full_state
    train_step.writer = dist.get_rank() == 0
    return train_step


def train_loop(cfg: ModelConfig, state: TrainState, step_fn: Callable, loader, run: RunConfig,
               *, num_steps: int, ckpt_manager=None,
               log: Optional[Callable[[int, Dict], None]] = None) -> Tuple[TrainState, Dict]:
    """``num_steps`` steps from ``loader`` (which yields (step, tokens,
    labels)); logs every ``run.log_every`` steps and saves every
    ``run.checkpoint_every`` (the checkpoint is named by the steps done):
    under data parallelism the state with its moments gathered whole
    (``step_fn.full_state``), the reference's format, written by one rank
    (``step_fn.writer``); ``checkpoint.restore_elastic`` cuts it again."""
    last: Dict[str, float] = {}
    for _ in range(num_steps):
        step, tokens, labels = next(loader)
        state, metrics = step_fn(state, tokens, labels)
        last = {k: float(v) for k, v in metrics.items()}
        if log is not None and step % run.log_every == 0:
            log(step, last)
        if ckpt_manager is not None and (step + 1) % run.checkpoint_every == 0:
            full = getattr(step_fn, "full_state", None)
            snapshot = full(state) if full is not None else state
            if getattr(step_fn, "writer", True):
                ckpt_manager.save(step + 1, snapshot)
    return state, last
