"""Nested-dict trees of tensors (a `ParamTree`, an optimizer state): the
port's counterpart of the few `jax.tree_util` calls the training path
makes. A node is anything with `keys()` and `[]`; a leaf is a tensor.
Keys are visited sorted at every level, the order in which the reference
flattens its dict pytrees."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Path = Tuple[str, ...]


def leaves(tree) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) of every leaf."""
    out = []
    for name in sorted(tree.keys()):
        val = tree[name]
        if isinstance(val, torch.Tensor):
            out.append(((name,), val))
        else:
            out.extend(((name,) + path, leaf) for path, leaf in leaves(val))
    return out


def from_paths(items) -> Dict:
    """[(path, value)] -> the nested dict holding each value at its path."""
    tree: Dict = {}
    for path, val in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def tree_map(fn: Callable, tree, *rest) -> Dict:
    """A nested dict of fn(leaf, *leaves of `rest` at the same path)."""
    return from_paths((path, fn(leaf, *(at(r, path) for r in rest)))
                      for path, leaf in leaves(tree))


def at(tree, path: Path):
    """The node or leaf at `path`."""
    for key in path:
        tree = tree[key]
    return tree
