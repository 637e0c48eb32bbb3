"""The layout of a weight tree, as a family's `spec(model)` lists it:
(path, shape, center, half_width) of every leaf, path a tuple of keys
and indices. `weights.make` draws leaf = center + (2u - 1) * half_width.
Products take the half-width of torch.nn.Linear's initialisation
(1 / sqrt(fan_in)); LayerNorm gains are drawn around 1 and biases
around 0."""

from __future__ import annotations

import math
from typing import List, Tuple

Spec = List[Tuple[tuple, tuple, float, float]]
LN_HALF = 0.1
BIAS_HALF = 0.1


def lin(spec: Spec, path: tuple, n_in: int, n_out: int) -> None:
    h = 1.0 / math.sqrt(n_in)
    spec.append((path + ("w",), (n_in, n_out), 0.0, h))
    spec.append((path + ("b",), (n_out,), 0.0, h))


def ln(spec: Spec, path: tuple, d: int) -> None:
    spec.append((path + ("g",), (d,), 1.0, LN_HALF))
    spec.append((path + ("b",), (d,), 0.0, LN_HALF))


def ffn(spec: Spec, path: tuple, d: int, mult: int) -> None:
    ln(spec, path + ("ln",), d)
    lin(spec, path + ("w1",), d, d * mult)
    lin(spec, path + ("w2",), d * mult, d)
