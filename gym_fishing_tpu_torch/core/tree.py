"""Leaf-by-leaf maps over the port's record types.

The JAX package registers its dataclasses as pytrees and maps over them with
``jax.tree``; the port's records are plain frozen dataclasses of tensors, and
these helpers walk them the same way. A tree is a dataclass instance, a
tuple, list or dict of trees, or a leaf (a tensor, a number, anything else);
``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple


def _is_record(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied to the leaves of `tree` and the matching leaves of
    `rest` (trees of the same structure); the structure of `tree` is kept."""
    if tree is None:
        return None
    if _is_record(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf of `tree`, in the order `tree_map` visits
    them; a path is a tuple of field names, keys and indices as strings."""
    if tree is None:
        return
    if _is_record(tree):
        for f in dataclasses.fields(tree):
            yield from tree_leaves_with_path(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
