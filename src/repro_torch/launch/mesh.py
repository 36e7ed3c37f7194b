"""Device meshes over ``torch.distributed`` (the reference's ``launch/mesh.py``).

Functions, not module constants: importing this module touches no process
group. Each builds a ``DeviceMesh`` through ``init_device_mesh`` with the
reference's axis names, over the process group the caller has started
(``distributed/world.py`` starts one for tests and ``chip_smoke.py``; a
launcher starts its own). Every rank of the world calls the same function.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes``, ranks laid out row-major (the
    last axis fastest, as ``jax.make_mesh``). It spans the whole world
    (``init_device_mesh``), or, in a larger world, its first
    ``prod(shape)`` ranks: a rank past them is in no mesh
    (``get_coordinate()`` is None) and takes no part in its collectives."""
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs a started process group "
                           f"of {need} ranks (distributed/world.py starts one)")
    world = dist.get_world_size()
    if world < need:
        raise RuntimeError(f"a {tuple(shape)} mesh over axes {tuple(axes)} needs {need} "
                           f"ranks; the world has {world}")
    if world == need:
        return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
    return DeviceMesh(device, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod ("data", "model"); 2 pods = 512 ranks
    ("pod", "data", "model") when ``multi_pod``. Raises unless the world
    has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} over {axes} needs a world of "
                           f"{math.prod(shape)} ranks, got {world}")
    return make_mesh(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1, device: str = "cuda") -> DeviceMesh:
    """A small ("data", "model") mesh over a world of ``data * model``
    ranks: tests and ``chip_smoke.py``."""
    return make_mesh((data, model), ("data", "model"), device)
