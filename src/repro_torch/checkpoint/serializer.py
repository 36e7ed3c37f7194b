"""Tree <-> disk serialization (numpy .npz + JSON manifest), the
reference's ``checkpoint/serializer.py`` format: each leaf keyed by its
tree path (``tree.items``: dict keys, sequence indices, joined by ``/``),
dtypes kept, bf16 stored as its uint16 bits under the key plus ``__bf16__``
(npz has no bfloat16). A file either package writes loads in the other.

Saving snapshots every leaf to host numpy (a copy, so the caller may
change its tensors afterwards). Loading fills a template: a torch leaf is
overwritten IN PLACE (its device and ``requires_grad`` kept; a full-width
train state has no room for a second copy on the card), any other leaf
comes back as the stored numpy array.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import items, map_with_path

_BF16_TAG = "__bf16__"


def _host_array(leaf: Any) -> Tuple[np.ndarray, bool]:
    """A leaf as a host numpy array of its own, and whether it is bf16 bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf), False
    t = leaf.detach()
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bf16 else t).cpu().numpy()
    if t.device.type == "cpu":
        a = a.copy()
    return (a.view(np.uint16) if bf16 else a), bf16


def tree_to_arrays(tree: Any) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, leaf in items(tree):
        a, bf16 = _host_array(leaf)
        out[key + _BF16_TAG if bf16 else key] = a
    return out


def _stored(arrays: Any, key: str) -> Tuple[np.ndarray, bool]:
    if key in arrays:
        return arrays[key], False
    if key + _BF16_TAG in arrays:
        return arrays[key + _BF16_TAG], True
    raise KeyError(f"checkpoint missing {key!r}")


def arrays_to_tree(template: Any, arrays: Any) -> Any:
    """``arrays`` (a dict, or an open npz read a member at a time) into
    ``template``'s structure; a shape or (for a tensor) dtype that differs
    from the template's raises ValueError."""
    def fill(key, leaf):
        a, bf16 = _stored(arrays, key)
        if tuple(a.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: shape {a.shape} != template {tuple(np.shape(leaf))}")
        if not isinstance(leaf, torch.Tensor):
            return a
        t = torch.from_numpy(np.asarray(a.view(np.int16) if bf16 else a, order="C"))
        t = t.view(torch.bfloat16) if bf16 else t
        if t.dtype != leaf.dtype:
            raise ValueError(f"{key}: dtype {t.dtype} != template {leaf.dtype}")
        with torch.no_grad():
            leaf.copy_(t)
        return leaf

    return map_with_path(fill, template)


def save_tree(path: str, tree: Any, meta: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = tree_to_arrays(tree)
    # atomic write: a temp file renamed (its suffix must be .npz or numpy appends one)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_tree(path: str, template: Any) -> Tuple[Any, Dict[str, Any]]:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        tree = arrays_to_tree(template, z)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return tree, meta
