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
