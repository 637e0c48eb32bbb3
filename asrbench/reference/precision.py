"""Rounding of product operands to a stated precision, for the plain
reference and for its control.

A precision names how the operands of a product are rounded before the
product is summed in float32 (the matmul itself runs with TF32 off, so a
float32 product of rounded operands is exact rounding then float32
accumulation):
  - "f32": no rounding;
  - "tf32": the mantissa rounded to 10 bits, to nearest, ties away from
    zero, as the tensor cores take float32 operands with TF32 on;
  - "bf16": rounded to bfloat16;
  - "fp8": rounded to float8 e4m3 after scaling the tensor so that its
    largest magnitude maps to 448 (per-tensor scaling, as fp8 GEMMs are
    run), then scaled back.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")
_FP8_MAX = 448.0


def _rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = _FP8_MAX / x.abs().max().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown precision {precision!r}")


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (float32) rounded to `precision`, returned as float32. Under
    autograd the rounding passes the gradient through unchanged, so a
    product's backward takes the rounded operands of its forward."""
    if precision == "f32":
        return x
    with torch.no_grad():
        r = _rounded(x.detach(), precision)
    return x + (r - x).detach() if x.requires_grad else r


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b with both operands rounded to `precision`, float32 sums."""
    return torch.matmul(round_to(a, precision), round_to(b, precision))
