"""Partition rules: every tensor of the system mapped onto mesh axes, as data
(the reference's ``distributed/sharding.py``).

Axis roles: the batch over the dp axes (``("pod", "data")`` on a multi-pod
mesh), experts (EP) and, in the sharded prefill, query positions (SP) over
``tp_axis``; ZeRO-1 shards the optimizer moments over the dp axes; FSDP
adds dp-axis sharding to parameter storage.

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, the last fastest), the reference's ``PartitionSpec`` as a plain
tuple; ``()`` is a replicated scalar. A path is a leaf's keys, as a tuple or
as ``tree.items``' ``"a/b/0/c"`` string. Where a rule needs only the axis
sizes, a mesh is a ``DeviceMesh`` or a mapping of axis name to size.

The reference keeps the tp and dp sizes its rules read as module-level
hints (``_TP_SIZE``, ``_DP_SIZE``) that its ``make_*_shardings`` set; here
they are arguments (``tp_size``, ``dp_size``), default 16 as the hints', and
the ``make_*`` functions take them from the mesh. Given the same sizes, every
rule answers as the reference's, including the heads-divide-tp rule for the
attention projections.

Layouts. The reference stacks repeated layers (a leading ``reps``
dimension, never sharded); the port keeps a list of layers (``"layers/3/
..."`` in the parameters and optimizer moments, one dict per layer in the
decode state). ``make_*`` answer for either: a port layer's leaf gets the
spec of its layer stacked alone (``reps`` 1) without that leading entry, so
both layouts follow the same rules. ZeRO-1 may put the dp axes on a stacked
``reps`` dimension; a port layer has none, and its moment takes the first
free dimension after it.

:func:`shard_tensor` cuts a full tensor to this rank's shard under a spec;
:func:`gather_tensor` gathers the shards back. :func:`residency_spec` rules
rotary residency's slot planes and LUTs (split on the expert width F).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.config.base import ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.tree import items

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
Path = Union[str, Sequence[str]]

HINT = 16       # the reference's default tp / dp size hints


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, or of a mapping of the same."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _keys(path: Path) -> Tuple[str, ...]:
    if isinstance(path, str):
        return tuple(k for k in path.split("/") if k)
    return tuple(str(k) for k in path)


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(n) for n in getattr(leaf, "shape", ()))


def _dp_entry(sh: ShardingConfig) -> Entry:
    """The dp axes as one entry: a lone axis by its name (``PartitionSpec``
    writes a one-axis tuple so)."""
    return sh.dp_axes if len(sh.dp_axes) > 1 else sh.dp_axes[0]


# ---------------------------------------------------------------------------
# Parameters and optimizer state
# ---------------------------------------------------------------------------
def param_spec(path: Path, shape: Sequence[int], cfg: ModelConfig, sh: ShardingConfig, *,
               fsdp: bool = False, tp_size: int = HINT) -> Spec:
    """One parameter leaf's spec. Stacked leaves carry a leading ``reps``
    dimension (never sharded): the rules address the trailing dimensions
    and pad on the left."""
    keys = _keys(path)
    name = keys[-1] if keys else ""
    tp = sh.tp_axis
    fa = _dp_entry(sh) if fsdp else None       # FSDP storage axes
    ndim = len(shape)

    def pad(tail: Spec) -> Spec:
        return (None,) * (ndim - len(tail)) + tuple(tail)

    if name == "embed":
        return (tp, fa)
    if name == "lm_head":
        return (fa, tp)
    if name == "frontend_proj":
        return (None, None)
    if "experts" in keys:                      # routed experts [reps?, E, D, F]: EP on E
        if name == "w_down":
            return pad((tp, fa, None))
        return pad((tp, None, fa))
    if name in ("router", "shared_gate"):
        return pad((None, None))
    if name in ("wq", "wk", "wv", "wo"):
        # heads sharded only when the head count divides the tp size; else a
        # flat [D, H*dh] split would cut heads mid-head_dim
        heads = (cfg.attention.num_heads if name in ("wq", "wo")
                 else cfg.attention.num_kv_heads)
        if heads % tp_size != 0:
            return pad((None, None))
        if name == "wo":
            return pad((tp, fa))
        return pad((fa, tp))
    if name in ("w_gate", "w_up", "w_in", "w_a", "w_b",
                "w_q", "w_k", "w_v", "w_if", "w_rg", "w_ig"):
        return pad((fa, tp))
    if name in ("w_down", "w_out"):
        return pad((tp, fa))
    if name == "conv_w":
        return pad((None, tp))
    if name == "r":                            # sLSTM block-diagonal [4, H, dh, dh]
        return pad((None, None, None))
    if name in ("lam", "conv_b", "skip"):
        return pad((tp,))
    if name in ("b", "b_if"):
        return pad((None,))
    return (None,) * ndim                      # norms, scales, biases


def sanitize_spec(spec: Spec, shape: Sequence[int], mesh: Any) -> Spec:
    """Drop the sharding of a dimension its axes do not divide (a tiny odd
    dimension is replicated instead of padded)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        out.append(None if shape[i] % math.prod(sizes[a] for a in axes) else entry)
    return tuple(out)


def opt_spec(path: Path, shape: Sequence[int], cfg: ModelConfig, sh: ShardingConfig, *,
             zero1: bool = True, tp_size: int = HINT, dp_size: int = HINT) -> Spec:
    """An optimizer leaf (``m/...``, ``v/...`` or ``step``): the parameter's
    spec (without FSDP), and under ZeRO-1 the dp axes on its first free
    dimension that ``dp_size`` divides and that is longer than 1."""
    keys = _keys(path)
    if keys and keys[-1] == "step":
        return ()
    base = param_spec(keys[1:], shape, cfg, sh, tp_size=tp_size)
    if not zero1:
        return base
    specs = list(base) + [None] * (len(shape) - len(base))
    for i, s in enumerate(specs):
        if s is None and shape[i] % dp_size == 0 and shape[i] > 1:
            specs[i] = _dp_entry(sh)
            break
    return tuple(specs)


def ef_spec(path: Path, shape: Sequence[int], cfg: ModelConfig, sh: ShardingConfig,
            mesh: Any, *, tp_size: int = HINT) -> Spec:
    """An error-feedback residual [pod, *param_shape] (``ef/...``): split
    over "pod", and "data" on the parameter's first free dimension that
    "data" divides and that is longer than 1. Not sanitized (the
    reference's rule)."""
    keys = _keys(path)
    base = param_spec(keys[1:], shape[1:], cfg, sh, tp_size=tp_size)
    specs = list(base) + [None] * (len(shape) - 1 - len(base))
    data = axis_sizes(mesh)["data"]
    for i, s in enumerate(specs):
        if s is None and shape[i + 1] > 1 and shape[i + 1] % data == 0:
            specs[i] = "data"
            break
    return ("pod", *specs)


def dp_size(mesh: Any, sh: ShardingConfig) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in sh.dp_axes)


def _port_layer(keys: Tuple[str, ...]) -> bool:
    """A leaf of the port's per-layer list (``layers/<i>/...``)."""
    return any(k == "layers" and nxt.isdigit() for k, nxt in zip(keys, keys[1:]))


def _layerwise(rule, keys: Tuple[str, ...], shape: Tuple[int, ...], stacked: bool) -> Spec:
    """``rule(shape)`` as a stacked leaf: a port layer's leaf is ruled as a
    stack of one layer (reps 1) and the leading entry dropped."""
    if not stacked:
        return rule(shape)
    return rule((1,) + shape)[1:]


def make_param_shardings(cfg: ModelConfig, mesh: Any, sh: ShardingConfig, params: Any, *,
                         fsdp: bool = False) -> Any:
    """{path: spec} for every parameter leaf (any leaf with a ``shape``),
    sanitized for ``mesh``; the tp size from the mesh."""
    tp = axis_sizes(mesh)[sh.tp_axis]

    def spec(path, leaf):
        keys, shape = _keys(path), _shape(leaf)
        return _layerwise(lambda s: sanitize_spec(
            param_spec(keys, s, cfg, sh, fsdp=fsdp, tp_size=tp), s, mesh),
            keys, shape, _port_layer(keys))

    return {path: spec(path, leaf) for path, leaf in items(params)}


def make_train_state_shardings(cfg: ModelConfig, mesh: Any, sh: ShardingConfig, state: Any,
                               *, fsdp: bool = False) -> Any:
    """{path: spec} for every train-state leaf: ``params/...`` as
    :func:`make_param_shardings`, ``opt/...`` by :func:`opt_spec` (ZeRO-1
    per ``sh.zero1``), ``ef/...`` by :func:`ef_spec`, anything else
    replicated."""
    sizes = axis_sizes(mesh)
    tp, dp = sizes[sh.tp_axis], dp_size(mesh, sh)

    def spec(path, leaf):
        keys, shape = _keys(path), _shape(leaf)
        layer = _port_layer(keys)
        if keys[0] == "params":
            return _layerwise(lambda s: sanitize_spec(
                param_spec(keys[1:], s, cfg, sh, fsdp=fsdp, tp_size=tp), s, mesh),
                keys, shape, layer)
        if keys[0] == "opt":
            return _layerwise(lambda s: sanitize_spec(
                opt_spec(keys[1:], s, cfg, sh, zero1=sh.zero1, tp_size=tp, dp_size=dp),
                s, mesh), keys, shape, layer)
        if keys[0] == "ef":
            if not layer:
                return ef_spec(keys, shape, cfg, sh, mesh, tp_size=tp)
            full = ef_spec(keys, (shape[0], 1) + shape[1:], cfg, sh, mesh, tp_size=tp)
            return full[:1] + full[2:]
        return ()

    return {path: spec(path, leaf) for path, leaf in items(state)}


# ---------------------------------------------------------------------------
# Activations, inputs, decode state
# ---------------------------------------------------------------------------
def _dp_or_none(mesh: Optional[Any], sh: ShardingConfig, n: int) -> Entry:
    """The dp axes if they divide the batch ``n``, else None (a batch of 1)."""
    if mesh is not None and n % dp_size(mesh, sh) != 0:
        return None
    return _dp_entry(sh)


def batch_spec(sh: ShardingConfig, mesh: Optional[Any] = None, global_batch: int = 0) -> Spec:
    """tokens / labels [B, S]."""
    return (_dp_or_none(mesh, sh, global_batch), None)


def token_spec(sh: ShardingConfig, mesh: Optional[Any] = None, global_batch: int = 0) -> Spec:
    """A decode step's tokens [B]."""
    return (_dp_or_none(mesh, sh, global_batch),)


def frontend_spec(sh: ShardingConfig, mesh: Optional[Any] = None,
                  global_batch: int = 0) -> Spec:
    """Frontend embeddings [B, F, frontend_dim]."""
    return (_dp_or_none(mesh, sh, global_batch), None, None)


def state_spec(path: Path, shape: Sequence[int], cfg: ModelConfig, sh: ShardingConfig,
               cell: ShapeConfig, mesh: Optional[Any] = None) -> Spec:
    """A stacked decode-state leaf: KV caches [reps, B, S, Hkv, dh] split the
    batch over dp and the sequence over tp; RG-LRU h [reps, B, W] and conv
    [reps, B, cw-1, W] the batch over dp and the width over tp; mLSTM C
    [reps, B, H, dk, dv] and any other leaf the batch over dp."""
    keys = _keys(path)
    dp = _dp_or_none(mesh, sh, cell.global_batch)
    nd = len(shape)
    name = keys[-1] if keys else ""
    if name in ("k", "v") and nd == 5:
        return (None, dp, sh.tp_axis, None, None)
    if name == "h" and nd == 3:
        return (None, dp, sh.tp_axis)
    if name == "conv" and nd == 4:
        return (None, dp, None, sh.tp_axis)
    if name == "c" and nd == 5:
        return (None, dp, None, None, None)
    if nd >= 2:
        return (None, dp) + (None,) * (nd - 2)
    return (None,) * nd


def make_state_shardings(cfg: ModelConfig, mesh: Any, sh: ShardingConfig, state: Any,
                         cell: ShapeConfig) -> Any:
    """{path: spec} for every decode-state leaf, sanitized for ``mesh``. The port's
    state (a list with one dict per layer) is ruled layer by layer as a
    stack of one; the reference's stacked tuples as they are."""
    per_layer = isinstance(state, list) and all(isinstance(s, dict) for s in state)

    def spec(path, leaf):
        keys, shape = _keys(path), _shape(leaf)
        return _layerwise(lambda s: sanitize_spec(
            state_spec(keys, s, cfg, sh, cell, mesh), s, mesh), keys, shape, per_layer)

    return {path: spec(path, leaf) for path, leaf in items(state)}


# ---------------------------------------------------------------------------
# Rotary residency: the slot planes and LUTs of the decode step
# ---------------------------------------------------------------------------
def residency_spec(name: str, sh: ShardingConfig) -> Spec:
    """One MoE layer's residency leaf (the reference's ``_residency_shardings``
    for a layer stacked alone, the leading ``reps`` entry dropped): the slot
    planes split on F over the tensor axis, ``w_gate`` / ``w_up`` [S+1, D, F]
    at ``(None, None, tp)`` and ``w_down`` [S+1, F, D] at ``(None, tp,
    None)``; the slot dimension stays whole, so any expert can land in any
    slot on every rank. The LUT [E] stays whole."""
    if name == "lut":
        return (None,)
    if name == "w_down":
        return (None, sh.tp_axis, None)
    if name in ("w_gate", "w_up"):
        return (None, None, sh.tp_axis)
    raise ValueError(f"no residency rule for {name!r} (unquantized slot planes only)")


def make_residency_shardings(cfg: ModelConfig, mesh: Any, sh: ShardingConfig,
                             residency: Sequence[Tuple[Mapping[str, Any], Any]]
                             ) -> list:
    """Per MoE layer ``{name: spec}`` for its planes and ``"lut"``
    (:func:`residency_spec`). Unlike the parameters' rules nothing is
    sanitized: an expert width F that the tensor axis does not divide
    raises."""
    tp = axis_sizes(mesh)[sh.tp_axis]
    f = cfg.moe.expert_d_ff
    if f % tp:
        raise ValueError(f"{cfg.name}: expert width {f} does not split over a tensor axis "
                         f"of {tp}")
    return [{**{n: residency_spec(n, sh) for n in planes}, "lut": residency_spec("lut", sh)}
            for planes, _ in residency]


# ---------------------------------------------------------------------------
# A full tensor and this rank's shard
# ---------------------------------------------------------------------------
def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_bounds(n: int, entry: Entry, mesh) -> Tuple[int, int]:
    """This rank's [start, stop) of a dimension of length ``n`` split over
    ``entry``'s axes (their coordinates combined row-major)."""
    sizes = axis_sizes(mesh)
    parts, idx = 1, 0
    for a in _axes(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        parts *= sizes[a]
    if n % parts:
        raise ValueError(f"a dimension of {n} does not split into {parts} shards over "
                         f"{_axes(entry)}")
    step = n // parts
    return idx * step, (idx + 1) * step


def shard_tensor(t: torch.Tensor, spec: Spec, mesh, device=None) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec`` on the
    ``DeviceMesh`` ``mesh`` (a rank must be in the mesh), on ``device``
    (default ``t``'s). A sharded leaf is a copy, so the full tensor can be
    freed; a replicated one is ``t`` itself (moved when ``device`` differs)."""
    out = t
    for dim, entry in enumerate(spec):
        if _axes(entry):
            lo, hi = shard_bounds(t.shape[dim], entry, mesh)
            out = out.narrow(dim, lo, hi - lo)
    if out is not t:
        out = out.to(device=device or t.device, copy=True)
    elif device is not None:
        out = out.to(device)
    return out


def gather_tensor(shard: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``shard`` under ``spec``: one
    ``all_gather`` per sharded axis over that axis's group, the last axis of
    an entry first (its coordinate runs fastest)."""
    out = shard.contiguous()
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            parts = [torch.empty_like(out) for _ in range(axis_sizes(mesh)[a])]
            dist.all_gather(parts, out, group=mesh.get_group(a))
            out = torch.cat(parts, dim=dim)
    return out
