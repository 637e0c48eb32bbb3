"""Linear op: y = act(x @ W + b), W stored [in, out] as in the JAX package.

The product goes to `torch.matmul`/`torch.mm` (cuBLAS on the card), as
the JAX package left it to XLA: no hand kernel is needed for a plain
large GEMM. With a `compute_dtype`, the operands are rounded to that
type and the products are summed in float32 (the JAX package's
`preferred_element_type=float32`); the result is float32.

How `matmul` takes such a product:
  - on CPU tensors, and with no compute_dtype, as a float32 GEMM of the
    rounded operands: products of two bf16 values are exact in float32,
    so this is the bf16 product with float32 accumulation, as XLA on the
    CPU computes it;
  - on CUDA tensors with a 16-bit compute_dtype, on the tensor cores in
    that type with float32 accumulation, through torch's float32-output
    overload (`torch.mm(..., out_dtype=float32)`, `aten::mm.dtype`, in
    the card's torch 2.11): the float32 sum comes back unrounded, so the
    caller's bias add and rounding are the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch


def uniform_init(generator: torch.Generator, shape, bound: float,
                 device="cpu", dtype=torch.float32) -> torch.Tensor:
    """U(-bound, bound) in `dtype`, drawn on the CPU from `generator` and
    then moved, so a seed gives the same weights on every device."""
    x = torch.rand(shape, generator=generator, dtype=dtype)
    return (x * (2 * bound) - bound).to(device)


def normal_init(generator: torch.Generator, shape, scale: float,
                device="cpu", dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) * scale in `dtype`, drawn on the CPU from `generator`."""
    x = torch.randn(shape, generator=generator, dtype=dtype)
    return (x * scale).to(device)


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                device="cpu", dtype=torch.float32) -> dict:
    """U(-1/sqrt(in), 1/sqrt(in)) on w and b (torch.nn.Linear's scale)."""
    bound = 1.0 / (in_dim ** 0.5)
    return {"w": uniform_init(generator, (in_dim, out_dim), bound, device,
                              dtype),
            "b": uniform_init(generator, (out_dim,), bound, device, dtype)}


def _tensor_core_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [K, N] or [..., K, N] (equal batch dims), 16-bit
    operands on the card -> float32."""
    if b.ndim == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    batch = a.shape[:-2]
    if b.shape[:-2] != batch:
        raise ValueError(f"matmul: batch dims {tuple(batch)} and "
                         f"{tuple(b.shape[:-2])} differ")
    y = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                  out_dtype=torch.float32)
    return y.reshape(*batch, a.shape[-2], b.shape[-1])


class _TensorCoreMatmul(torch.autograd.Function):
    """`_tensor_core_product` with the backward of the JAX package's mixed
    dot: d a = (g @ b^T) and d b = (a^T @ g) as float32 products of the
    float32 cotangent, each rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tensor_core_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.ndim == 2:
                gb = torch.matmul(a.reshape(-1, a.shape[-1]).float().t(),
                                  g.reshape(-1, g.shape[-1]))
            else:
                gb = torch.matmul(a.float().transpose(-1, -2), g)
            gb = gb.to(b.dtype)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a @ b in float32, the operands first rounded to compute_dtype (see
    the module docstring for how each device takes the product)."""
    if compute_dtype is None:
        return torch.matmul(a, b)
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if a.device.type == "cuda" and compute_dtype in (torch.bfloat16,
                                                     torch.float16):
        return _TensorCoreMatmul.apply(a, b)
    return torch.matmul(a.float(), b.float())


def linear(params: dict, x: torch.Tensor, activation: Optional[str] = "relu",
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [..., in] -> [..., out] float32. activation in {None, 'relu', 'tanh'}."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        b = b.to(compute_dtype)
    y = matmul(x, w, compute_dtype) + b.float()
    if activation == "relu":
        y = torch.relu(y)
    elif activation == "tanh":
        y = torch.tanh(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y
