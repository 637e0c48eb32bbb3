"""Linear op: y = act(x @ W + b), W stored [in, out] as in the JAX package.

The product goes to `torch.matmul` (cuBLAS on the card), as the JAX
package left it to XLA: no hand kernel is needed for a plain large GEMM.
With a `compute_dtype`, the operands are rounded to that type and the
product is taken in float32, so the result is float32 with float32
accumulation (the JAX package's `preferred_element_type=float32`).
"""

from __future__ import annotations

from typing import Optional

import torch


def uniform_init(generator: torch.Generator, shape, bound: float,
                 device="cpu") -> torch.Tensor:
    """U(-bound, bound) float32, drawn on the CPU from `generator` and then
    moved, so a seed gives the same weights on every device."""
    x = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (x * (2 * bound) - bound).to(device)


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                device="cpu") -> dict:
    """U(-1/sqrt(in), 1/sqrt(in)) on w and b (torch.nn.Linear's scale)."""
    bound = 1.0 / (in_dim ** 0.5)
    return {"w": uniform_init(generator, (in_dim, out_dim), bound, device),
            "b": uniform_init(generator, (out_dim,), bound, device)}


def linear(params: dict, x: torch.Tensor, activation: Optional[str] = "relu",
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [..., in] -> [..., out] float32. activation in {None, 'relu', 'tanh'}."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
        b = b.to(compute_dtype)
    y = torch.matmul(x, w) + b.float()
    if activation == "relu":
        y = torch.relu(y)
    elif activation == "tanh":
        y = torch.tanh(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y
