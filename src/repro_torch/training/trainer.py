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

Training over a (data, model) mesh (``rt.mesh`` with one data axis and the
tensor axis; the reference's ``train_cell`` under GSPMD, whose semantics
are those of the global arrays). ``tokens`` / ``labels`` are this data
rank's rows (:func:`data_rows`), the same on every rank of the tensor
axis: the reference reshapes the global batch [B, S] to [num_micro, B /
num_micro, S], and under its mesh each microbatch's MoE half runs in a
``shard_map`` with ``in_specs`` ``P(dp, None)``, so data rank r holds rows
``i mb + [r mb / dp, (r + 1) mb / dp)`` of microbatch i (mb = B /
num_micro), and its sorted dispatch keeps a per-data-shard capacity over
those rows. Each rank's loss is its share of the reference's: its label
sum over each microbatch's global count of valid labels (the counts
all-reduced once, before the forward) plus the MoE terms over the data
ranks, so the gradients are SUMMED over the data axis. The reference's MoE
terms leave that ``shard_map`` through ``out_specs`` ``P()`` unchecked:
their gradient is the mean over the data shards (reproduced here), their
value one shard's (the port reports the mean; ``metrics["lm_xent"]`` is the
cross-entropy part alone). Over the model axis the reference departs from
its own unsharded gradient in nothing (measured, reduced qwen36 at (data 1,
model 2)), and neither does the port.

Each rank stores its shard of every leaf (``init_train_state(mesh=)``:
``shard_params`` at ``param_spec``; :func:`state_layout`) and runs the
model's tensor-parallel train forms (``models/transformer.py``: heads and
MLPs split, experts expert-parallel with the router losses, SP attention
for long sequences whose heads the axis does not divide, the
vocabulary-parallel embedding and loss). A leaf whole on every model rank
whose gradient a rank computes for its share only
(``transformer.tp_partial_leaves``) is summed over the model axis in f32;
every gradient is then summed over the data axis. Under ZeRO-1
(``rt.sharding.zero1``) each moment is stored at its ``opt_spec`` shard
(the data axis on the first free dimension that divides), that leaf's
gradient reduce-scattered along it, every other leaf's all-reduced; AdamW
runs on the shards and the parameters are all-gathered after it. FSDP
storage (``fsdp=True``, ``param_spec(fsdp=True)``): a leaf split over the
data axis is gathered whole at its use, inside each layer's remat'd block
(``parallel.gather_at_use``, whose backward reduce-scatters: that is the
leaf's data-axis sum), its moments lie beside its shard, and AdamW updates
the shard with no gather after it. The gradient norm counts every element
once: each leaf's squares summed per piece (its tensor shard, its FSDP or
ZeRO-1 piece on the data axis, ZeRO-1 on or off) and the pieces added in
rank order, so ZeRO-1 on and off take the same steps. ``full_state``
gathers both axes (the reference's layout, a checkpoint's). A recurrent
stack over a tensor axis longer than 1 raises (the width split of its
layers is a later slice), as do split experts without ``moe_impl="epsum"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import KV_KINDS, ModelConfig, RunConfig, ShardingConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import (
    _dp_entry, axis_sizes, gather_tensor, make_param_shardings, make_train_state_shardings,
)
from repro_torch.models.transformer import (
    Runtime, init_params, loss_targets, lm_loss, shard_params, tp_partial_leaves,
)
from repro_torch.training import compression
from repro_torch.training.optimizer import adamw_apply, adamw_init, adamw_update
from repro_torch.tree import items, leaves, replace_leaves

TrainState = Dict[str, Any]


def init_train_state(cfg: ModelConfig, params: Any,
                     sharding_cfg: Optional[ShardingConfig] = None, *,
                     mesh: Any = None, fsdp: bool = False) -> TrainState:
    """``{"params", "opt"}``: the parameters (marked to take gradients) and
    AdamW's state beside them; under ``grad_compression="int8_ef"`` also
    ``"ef"``, this rank's slice [1, *shape] of the reference's [pod_count,
    *shape] bf16 residual (zeros: every pod holds its own). With ``mesh``
    (training over a (data, model) mesh) ``params`` are whole and each leaf
    keeps this rank's shard at its ``param_spec`` (``shard_params``: the
    tensor axis, and with ``fsdp`` the data axis too), each moment at its
    storage spec (:func:`state_layout`)."""
    sh = sharding_cfg or ShardingConfig()
    if mesh is not None:
        layout = state_layout(cfg, mesh, sh, fsdp=fsdp)
        if any(lay.tp is not None or lay.fsdp is not None for lay in layout.values()):
            params = shard_params(cfg, params, Runtime(sharding=sh, mesh=mesh), fsdp=fsdp)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params)
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for key in ("m", "v"):
            opt[key] = replace_leaves(opt[key], [
                torch.zeros(_local_shape(lay.mspec, lay.shape, sizes), dtype=m.dtype,
                            device=m.device) if lay.mspec != lay.pspec else m
                for m, lay in zip(leaves(opt[key]), layout.values())])
    state: TrainState = {"params": params, "opt": opt}
    if sh.grad_compression == "int8_ef":
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


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One parameter leaf on a (data, model) mesh: its global ``shape``, the
    spec its stored shard follows (``pspec``: ``param_spec``, with FSDP's
    data axis under ``fsdp``) and each moment's (``mspec``), and the
    dimensions split over the tensor axis (``tp``), over the data axis in
    storage (``fsdp``) and by ZeRO-1 (``zero``: ``opt_spec``'s with
    ``zero1``, for a leaf not FSDP-split, whether or not ZeRO-1 is on: the
    gradient norm sums its squares over those pieces either way)."""

    shape: Tuple[int, ...]
    pspec: Tuple
    mspec: Tuple
    tp: Optional[int]
    fsdp: Optional[int]
    zero: Optional[int]

    @property
    def moment_dim(self) -> Optional[int]:
        """The dimension a moment splits over the data axis, or None."""
        return self.fsdp if self.fsdp is not None else (
            self.zero if self.mspec != self.pspec else None)


def _index(spec: Tuple, entry) -> Optional[int]:
    return next((i for i, e in enumerate(spec) if e == entry), None)


def _local_shape(spec: Tuple, shape: Tuple[int, ...], sizes: Dict[str, int]) -> Tuple[int, ...]:
    out = []
    for n, e in zip(shape, spec):
        axes = () if e is None else (tuple(e) if isinstance(e, (tuple, list)) else (e,))
        for a in axes:
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def state_layout(cfg: ModelConfig, mesh: Any, sh: ShardingConfig, *,
                 fsdp: bool = False) -> Dict[str, LeafLayout]:
    """{path: :class:`LeafLayout`} in ``tree.leaves`` order, from the
    configuration's shapes (``init_params`` on the meta device) and the
    rules sanitized for ``mesh``. A moment follows ``opt_spec`` (ZeRO-1 per
    ``sh.zero1``), except that an FSDP-split leaf's moments follow its
    stored shard (AdamW updates the shard where it lies; for the routed
    experts' ``w_gate`` / ``w_up`` that is E x D x F/dp, where ``opt_spec``
    would split D)."""
    meta = init_params(cfg, 0, "meta")
    pspecs = make_param_shardings(cfg, mesh, sh, meta, fsdp=fsdp)
    zspecs = make_train_state_shardings(cfg, mesh, dataclasses.replace(sh, zero1=True),
                                        {"opt": {"m": meta}})
    dp = _dp_entry(sh)
    out = {}
    for path, leaf in items(meta):
        ps, zs = pspecs[path], zspecs[f"opt/m/{path}"]
        fd = _index(ps, dp)
        ms = ps if fd is not None or not sh.zero1 else zs
        out[path] = LeafLayout(tuple(leaf.shape), ps, ms, _index(ps, sh.tp_axis), fd,
                               None if fd is not None else _index(zs, dp))
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


class _MeshStep:
    """One data axis and the tensor axis of ``rt.mesh`` for the step over a
    (data, model) mesh (the other axes of length 1); raises before anything
    is built otherwise, and for what the model axis does not train yet: a
    recurrent stack's width split, and split experts without ``epsum``."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, fsdp: bool):
        sh = rt.sharding
        sizes = axis_sizes(rt.mesh)
        tp = sizes.get(sh.tp_axis, 1)
        long = [a for a, n in sizes.items() if n > 1 and a != sh.tp_axis]
        if any(a not in sh.dp_axes for a in long) or len(long) > 1:
            raise ValueError(f"training over a mesh takes one data axis of {sh.dp_axes} longer "
                             f"than 1 and the tensor axis {sh.tp_axis!r}, the mesh has {sizes}")
        recurrent = [k for k in cfg.layer_kinds if k not in KV_KINDS]
        if tp > 1 and recurrent:
            raise ValueError(f"{cfg.name}: training {recurrent[0]} layers over a tensor axis of "
                             f"{tp} is not ported (the width split of a recurrent layer)")
        self.cfg, self.mesh, self.sh, self.fsdp = cfg, rt.mesh, sh, fsdp
        self.layout = state_layout(cfg, rt.mesh, sh, fsdp=fsdp)
        if tp > 1 and any(lay.tp is not None for path, lay in self.layout.items()
                          if "/experts/" in path):
            rt.ep_axis()                            # split experts train expert-parallel
        self.sizes = sizes
        self.axis = long[0] if long else sh.dp_axes[0]
        self.size = sizes.get(self.axis, 1)
        self.rank = rt.mesh.get_local_rank(self.axis)
        self.group = rt.mesh.get_group(self.axis)
        self.tp = tp
        self.tp_rank = rt.tp_rank() if tp > 1 else 0
        self.tp_group = rt.tp_group() if tp > 1 else None
        self.rt = rt if tp > 1 else dataclasses.replace(rt, mesh=None)   # the forward's
        self.checked = False

    def setup(self, params: Any, opt: Dict) -> None:
        """The stored shapes checked against the layout, once."""
        if self.checked:
            return
        for (path, lay), p, m in zip(self.layout.items(), leaves(params), leaves(opt["m"])):
            want = (_local_shape(lay.pspec, lay.shape, self.sizes),
                    _local_shape(lay.mspec, lay.shape, self.sizes))
            if (tuple(p.shape), tuple(m.shape)) != want:
                raise ValueError(f"{path}: a parameter of {tuple(p.shape)} with moments of "
                                 f"{tuple(m.shape)}: expected {want} (init_train_state(mesh=, "
                                 f"fsdp={self.fsdp}) with zero1={self.sh.zero1})")
        self.checked = True

    def gather(self, prefix: str, tree: Any) -> Any:
        """FSDP: a subtree's stored shards whole over the data axis
        (``parallel.gather_at_use``, differentiable)."""
        if isinstance(tree, dict):
            return {k: self.gather(f"{prefix}/{k}", v) for k, v in tree.items()}
        d = self.layout[prefix].fsdp
        return tree if d is None else parallel.gather_at_use(tree, d, self.group, self.size)

    def shard(self, t: torch.Tensor, d: int, r: int) -> torch.Tensor:
        n = t.shape[d] // self.size
        return t.narrow(d, r * n, n)

    def reduce(self, params: Any, grads: List[torch.Tensor], seq: int) -> List[torch.Tensor]:
        """The gradients this rank updates with: the partial ones of
        replicated leaves (``tp_partial_leaves``) summed over the tensor
        axis in f32 (one all-reduce), then summed over the data axis: an
        FSDP shard already (``gather_at_use``'s backward), a ZeRO-1 leaf's
        shard by a reduce-scatter along its moments' dimension, any other
        leaf whole (all-reduce)."""
        grads = list(grads)
        if self.tp > 1:
            partial = set(tp_partial_leaves(self.cfg, params, self.rt, seq))
            idx = [i for i, path in enumerate(self.layout) if path in partial]
            if idx:
                flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
                parallel.all_reduce_(flat, self.tp_group)
                for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
                    grads[i] = part.reshape(grads[i].shape).to(grads[i].dtype)
        if self.size == 1:
            return grads
        out = []
        for g, lay in zip(grads, self.layout.values()):
            d = lay.moment_dim
            if lay.fsdp is not None:
                out.append(g)
            elif d is not None:
                out.append(parallel.reduce_scatter_dim(g, d, self.group, self.size))
            else:
                out.append(parallel.all_reduce_(g.contiguous(), self.group))
        return out

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm, each element once: a leaf's squares
        summed per piece (its tensor-axis shard, and its data-axis piece
        along the FSDP or ZeRO-1 dimension: this rank's shard, or its slice
        of a whole reduced gradient), the pieces all-gathered and added leaf
        by leaf in (data, tensor) rank order; a piece replicated over an
        axis counted by that axis' rank 0 only."""
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        mine = []
        for g, lay in zip(grads, self.layout.values()):
            d = lay.fsdp if lay.fsdp is not None else lay.zero
            if d is None:
                piece = g if self.rank == 0 else None
            elif lay.moment_dim is not None:
                piece = g
            else:
                piece = self.shard(g, d, self.rank)
            counted = piece is not None and (lay.tp is not None or self.tp_rank == 0)
            mine.append(torch.sum(torch.square(piece.float())) if counted else zero)
        per = torch.stack(mine)[None]
        if self.tp > 1:
            per = parallel.all_gather_dim(per, 0, self.tp_group, self.tp)
        per = per[None]
        if self.size > 1:
            per = parallel.all_gather_dim(per, 0, self.group, self.size)
        tot = zero
        for j in range(per.shape[-1]):
            for a in range(per.shape[0]):
                for b in range(per.shape[1]):
                    tot = tot + per[a, b, j]
        return torch.sqrt(tot)

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor], opt: Dict,
               run: RunConfig) -> Dict[str, torch.Tensor]:
        """AdamW on the shards this rank stores (an FSDP shard, a ZeRO-1
        shard of its parameter, or the whole leaf); a ZeRO-1 shard is
        all-gathered into the parameter after it, an FSDP shard stays."""
        gnorm = self.norm(grads)
        ps = leaves(params)
        views = [self.shard(p, lay.zero, self.rank)
                 if lay.fsdp is None and lay.moment_dim is not None and self.size > 1 else p
                 for p, lay in zip(ps, self.layout.values())]
        lr = adamw_apply(views, grads, leaves(opt["m"]), leaves(opt["v"]), opt, run, gnorm)
        for p, v, lay in zip(ps, views, self.layout.values()):
            if v is not p:
                p.copy_(parallel.all_gather_dim(v, lay.zero, self.group, self.size))
        return {"grad_norm": gnorm, "lr": lr}

    def full_state(self, state: TrainState) -> TrainState:
        """The state in the reference's layout (every parameter and moment
        whole, gathered over both axes): what a checkpoint saves."""
        lays = list(self.layout.values())
        params = replace_leaves(state["params"], [
            gather_tensor(p.detach(), lay.pspec, self.mesh)
            for p, lay in zip(leaves(state["params"]), lays)])
        opt = dict(state["opt"])
        for key in ("m", "v"):
            opt[key] = replace_leaves(opt[key], [
                gather_tensor(m, lay.mspec, self.mesh) for m, lay in zip(leaves(opt[key]), lays)])
        return {**state, "params": params, "opt": opt}


def make_train_step(cfg: ModelConfig, rt: Runtime, run: RunConfig, *, num_micro: int = 1,
                    pod_compression: bool = False, pod_count: int = 2,
                    fsdp: bool = False) -> Callable:
    """Returns ``train_step(state, tokens, labels, frontend=None) -> (state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors;
    ``state`` is updated in place. Gradients travel as a list in
    ``tree.leaves`` order, the order ``adamw_update`` walks the parameters.
    ``pod_compression``: the cross-pod int8 reduction over ``rt.mesh``'s
    "pod" axis of ``pod_count`` ranks (a state with ``"ef"``), each rank
    given its pod's rows. ``rt.mesh`` without ``pod_compression``: the step
    over a (data, model) mesh (module docstring), given this data rank's
    rows (:func:`data_rows`) and a state from ``init_train_state(mesh=,
    fsdp=)`` with the same ``fsdp``; ``train_step.full_state(state)`` gives
    the state whole (a checkpoint's), ``train_step.writer`` is True on the
    one rank that writes it. metrics add ``lm_xent``, the cross-entropy
    part of the loss."""
    pod_group = _pod_group(rt, pod_count) if pod_compression else None
    if rt.mesh is not None and not pod_compression:
        return _mesh_train_step(cfg, run, _MeshStep(cfg, rt, fsdp), num_micro)
    if fsdp:
        raise ValueError("fsdp=True stores parameters over a mesh's data axis (rt.mesh)")

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


def _mesh_train_step(cfg: ModelConfig, run: RunConfig, ms: _MeshStep,
                     num_micro: int) -> Callable:
    gather = ms.gather if ms.fsdp else None
    front = cfg.frontend_len if cfg.frontend is not None else 0

    def train_step(state: TrainState, tokens: torch.Tensor, labels: torch.Tensor,
                   frontend: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict]:
        params = state["params"]
        ms.setup(params, state["opt"])
        n = max(num_micro, 1)
        mb = tokens.shape[0] // n
        tgt = loss_targets(cfg, labels)
        counts = torch.stack([(tgt[i * mb:(i + 1) * mb] >= 0).sum()
                              for i in range(n)]).to(torch.float32)
        if ms.size > 1:
            parallel.all_reduce_(counts, ms.group)   # each microbatch's global count
        grads: Optional[List[torch.Tensor]] = None
        sums = torch.zeros(2, dtype=torch.float32, device=tokens.device)   # loss, xent
        for i in range(n):
            rows = slice(i * mb, (i + 1) * mb)
            loss, aux = lm_loss(cfg, params, tokens[rows], labels[rows], ms.rt,
                                None if frontend is None else frontend[rows],
                                count=counts[i], aux_weight=1.0 / ms.size, gather=gather)
            g = torch.autograd.grad(loss, leaves(params))
            part = torch.stack([loss.detach(), aux["lm_xent"]]).float()
            if n == 1:
                grads, sums = list(g), part
            else:
                grads = ([gi.float() / n for gi in g] if grads is None
                         else [a.add_(gi.float() / n) for a, gi in zip(grads, g)])
                sums = sums + part / n
        if ms.size > 1:
            parallel.all_reduce_(sums, ms.group)
        grads = ms.reduce(params, grads, tokens.shape[1] + front)
        metrics = ms.update(params, grads, state["opt"], run)
        metrics.update(loss=sums[0], lm_xent=sums[1])
        return state, metrics

    train_step.full_state = ms.full_state
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
