"""Parameter trees: nested dicts, lists and tuples of tensors (the port's
stand-in for JAX pytrees). Dicts keep their insertion order; a leaf is
anything that is not a dict, list or tuple.

A leaf's path is written as JAX's ``keystr`` writes it (``['blocks'][3]
['attn']['wq']['w']``), so checkpoints and masks name leaves the same
way, and a per-layer list of ``blocks`` gives each layer a stable key.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def tree_map_with_path(fn: Callable, tree, *rest, path: str = ""):
    """``fn(path, leaf, *leaves of rest)`` over every leaf of ``tree``;
    ``rest`` are trees of the same structure. Returns a tree of that
    structure."""
    if is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                         path=f"{path}[{i}]")
                      for i, v in enumerate(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over every leaf of ``tree``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_flatten_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """Every (path, leaf) of ``tree``, in order."""
    if is_leaf(tree):
        return [(path, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(tree_flatten_with_path(child, path + key))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]
