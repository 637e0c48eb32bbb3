"""Weights made from the seed on the device, handed to the program and
to the reference alike.

The tree has the names and layouts the program's models take (a
linear's "w" is [in, out]); each family's `spec` in
`reference/<family>.py` lists its leaves (`reference/spec.py`). Every
leaf comes from one uniform draw of a generator on the device, seeded
from `--seed`: leaf = center +
(2u - 1) * half_width, with the half-width of torch.nn.Linear's
initialisation (1 / sqrt(fan_in)) for products, and of unit-variance
scales elsewhere. LayerNorm gains are drawn around 1 and every bias,
also the attention's u and v, around 0, so that the reference checks
them all.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from asrbench import reference

def _place(tree, path: tuple, leaf) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def make(family: str, model: Dict, generator: torch.Generator,
         device) -> Dict:
    """The weight tree of `family` at the sizes of `model`, drawn from
    `generator` (on `device`) in one call."""
    spec = reference.family(family).spec(model)
    total = sum(math.prod(s) for _, s, _, _ in spec)
    u = torch.rand(total, generator=generator, device=device)
    tree: Dict = {}
    off = 0
    for path, shape, center, half in spec:
        n = math.prod(shape)
        leaf = (u[off:off + n] * (2 * half) + (center - half)).view(shape)
        _place(tree, path, leaf)
        off += n
    return tree


def with_leaves(tree, new: List[torch.Tensor]):
    """A tree of `tree`'s shape whose leaves are `new`, in `leaves`'
    order."""
    it = iter(new)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]
    return walk(tree)


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in the tree's order."""
    out = []

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            out.append((prefix, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
    walk(tree, "")
    return out
