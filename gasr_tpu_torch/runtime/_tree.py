"""Walking nested containers of tensors (the JAX package's pytree
leaves): dicts, lists, tuples (named tuples too) and dataclasses."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import torch


def tensors(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor in `tree`, depth first, in container order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` on every leaf of `tree` (anything that is not a dict, list or
    tuple) and the leaves at the same place in each of `rest`, which
    follow `tree`'s structure (JAX's `tree.map`; a leaf of `rest` may be a
    container, such as a `parallel.sharding.Spec`). Dicts keep `tree`'s
    key order."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def leaves(tree: Any) -> Iterator[Any]:
    """Every leaf of `tree` in `tree_map`'s order."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree
