"""Nested dicts / lists / tuples of tensors ("trees"): the parameter and
train-state layout. Leaves come in JAX's pytree order (dict keys sorted,
sequences by index), so a leaf's path names it as the reference's
checkpoint serializer names it (``"opt/m/embed"``, ``"list/0"``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in order; a path joins keys and indices by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves, the structure kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, the structure kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def replace_leaves(tree: Any, values: List[Any]) -> Any:
    """``tree`` with its leaves replaced by ``values``, given in
    :func:`items` order (dict keys sorted), the structure kept."""
    it = iter(values)

    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            new = {k: walk(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
