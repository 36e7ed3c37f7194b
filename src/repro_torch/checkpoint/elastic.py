"""Elastic resharding: restore a checkpoint onto a mesh of another size
(the reference's ``checkpoint/elastic.py``).

Checkpoints hold full host arrays whatever mesh saved them
(``serializer.py``), so restoring onto a mesh means choosing a spec per leaf
for the target mesh and keeping this rank's shard of each leaf on this
rank's device. A job that loses ranks restarts on the smaller mesh from the
same bytes; growing works the same way.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.sharding import Spec, shard_tensor
from repro_torch.tree import map_tree, map_with_path


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card for a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def reshard_tree(tree: Any, mesh, spec_fn: Optional[Callable[[str, Any], Spec]] = None) -> Any:
    """Each leaf as a tensor; on a ``DeviceMesh``, this rank's shard under
    ``spec_fn(path, leaf)`` (default replicated: the whole leaf) on this
    rank's device. Without a mesh the leaves stay where they are."""
    if mesh is None:
        return map_tree(torch.as_tensor, tree)
    device = mesh_device(mesh)

    def put(path, leaf):
        spec = spec_fn(path, leaf) if spec_fn is not None else ()
        return shard_tensor(torch.as_tensor(leaf), spec, mesh, device)

    return map_with_path(put, tree)


def restore_elastic(manager, template: Any, mesh, spec_fn: Optional[Callable] = None):
    """``restore_latest`` and :func:`reshard_tree` onto ``mesh``: (step,
    state, meta), or None without a checkpoint. ``template`` has the full
    shapes (on the host: the whole state is read before it is cut)."""
    got = manager.restore_latest(template)
    if got is None:
        return None
    step, state, meta = got
    return step, reshard_tree(state, mesh, spec_fn), meta
