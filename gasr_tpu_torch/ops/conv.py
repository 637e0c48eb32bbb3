"""Convolutions with the JAX package's layouts (`gasr_tpu/ops/conv.py`):
channels-last input (NHWC, or NWC in 1-D) and HWIO (WIO) weights at the
public functions, torch's channels-first layout only inside.

Padding follows lax exactly. "SAME" gives out = ceil(n / s) and pads
max((out - 1) * s + k - n, 0) in all, the lower half (rounded down)
before and the rest after: for k = 3, s = 2 on an even n that is (0, 1),
which `F.conv2d(padding=1)` would not reproduce, so the pad is explicit.
A sequence of (lo, hi) pairs, one a spatial dim, pads as given (lax's
explicit padding; torch's `padding=1` is ((1, 1), (1, 1))).

Reduced precision follows `ops/linear.py`: the operands are rounded to
the compute dtype and the products summed in float32. On CPU tensors the
convolution runs in float32 on the rounded operands (exact products, as
XLA on the CPU). On CUDA tensors it runs in bf16 through cuDNN, which
sums in float32 and rounds its output to bf16 once before the caller
adds the bias in float32: an extra rounding of at most half a bf16 ulp.
A float32 convolution on the card is float32 only with
`torch.backends.cudnn.allow_tf32 = False`, which a caller checking
float32 parity sets.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.linear import uniform_init


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax "SAME" padding (lo, hi) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
          padding) -> List[Tuple[int, int]]:
    """(lo, hi) of every spatial dim: "SAME"'s, or the pairs given."""
    n = x.ndim - 2
    if padding == "SAME":
        return [same_pads(x.shape[1 + i], w.shape[i], stride[i])
                for i in range(n)]
    return [tuple(p) for p in padding]


def _conv_forward(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                  pads: Sequence[Tuple[int, int]], groups: int
                  ) -> torch.Tensor:
    """The reduced-dtype convolution (see `conv_mixed`)."""
    n = x.ndim - 2
    xc = x.movedim(-1, 1)                       # [B, C, *spatial]
    wc = w.permute(n + 1, n, *range(n))         # [O, C // groups, *kernel]
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        xc = F.pad(xc, flat)
    conv = F.conv1d if n == 1 else F.conv2d
    if n == 2:
        # channels-last in memory: cuDNN then writes NHWC, and the
        # movedim below is a free view
        xc = xc.contiguous(memory_format=torch.channels_last)
        wc = wc.contiguous(memory_format=torch.channels_last)
    if x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        y = conv(xc, wc.to(x.dtype), stride=tuple(stride), groups=groups)
    else:
        y = conv(xc.float(), wc.float(), stride=tuple(stride), groups=groups)
    return y.movedim(1, -1).float()


def _conv_f32_vjp(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                  pads: Sequence[Tuple[int, int]], groups: int,
                  g: torch.Tensor, needs: Tuple[bool, bool]):
    """The VJP of the float32 twin of `_conv_forward` (operands cast to
    float32, the same pads, stride and groups) at (x, w), by one
    `convolution_backward`: the input and weight gradients at x's and
    w's dtypes (None where `needs` says no)."""
    n = x.ndim - 2
    xc = F.pad(x.movedim(-1, 1).float(),
               [p for lo_hi in reversed(pads) for p in lo_hi])
    wc = w.permute(n + 1, n, *range(n)).float()
    gc = g.movedim(-1, 1).float()
    if n == 2:
        xc = xc.contiguous(memory_format=torch.channels_last)
        wc = wc.contiguous(memory_format=torch.channels_last)
        gc = gc.contiguous(memory_format=torch.channels_last)
    gx, gw, _ = torch.ops.aten.convolution_backward(
        gc, xc, wc, None, list(stride), [0] * n, [1] * n, False, [0] * n,
        groups, [needs[0], needs[1], False])
    if gx is not None:
        for i, (lo, _) in enumerate(pads):       # drop the pad's gradient
            gx = gx.narrow(2 + i, lo, x.shape[1 + i])
        gx = gx.movedim(1, -1).to(x.dtype)
    if gw is not None:
        gw = gw.permute(*range(2, n + 2), 1, 0).to(w.dtype)
    return gx, gw


class _ConvMixed(torch.autograd.Function):
    """The JAX package's `conv_mixed` custom_vjp: the reduced-dtype
    convolution forward, the float32 twin's VJP backward."""

    @staticmethod
    def forward(ctx, x, w, stride, pads, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads, ctx.groups = tuple(stride), pads, groups
        return _conv_forward(x, w, stride, pads, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = _conv_f32_vjp(x, w, ctx.stride, ctx.pads, ctx.groups, g,
                               ctx.needs_input_grad[:2])
        return gx, gw, None, None, None


def conv_mixed(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
               padding="SAME", groups: int = 1) -> torch.Tensor:
    """The JAX package's `conv_mixed` with "SAME" padding or explicit
    (lo, hi) pairs, one a spatial dim (lax's two forms): x
    [B, *spatial, C] (channels last),
    w [*kernel, C // groups, O] -> float32 [B, *spatial', O], with the
    products summed in float32 at the operands' dtype (see the module
    docstring). Differentiable: the backward is the VJP of the float32
    twin (the operands cast to float32, then the same convolution),
    cotangents at the operands' dtypes, as in the JAX package."""
    n = x.ndim - 2
    if n not in (1, 2) or w.ndim != n + 2:
        raise ValueError(f"conv_mixed: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not a 1-D or 2-D conv")
    if padding != "SAME" and (isinstance(padding, str)
                              or len(padding) != n):
        raise ValueError(f"conv_mixed: padding {padding!r} is neither "
                         f"'SAME' nor {n} (lo, hi) pairs")
    pads = _pads(x, w, stride, padding)
    return _ConvMixed.apply(x, w, tuple(stride), pads, groups)


def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                kernel: Tuple[int, int], device="cpu",
                dtype=torch.float32) -> dict:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) HWIO weight and bias."""
    bound = (1.0 / (in_ch * kernel[0] * kernel[1])) ** 0.5
    return {"w": uniform_init(generator, tuple(kernel) + (in_ch, out_ch),
                              bound, device, dtype),
            "b": uniform_init(generator, (out_ch,), bound, device, dtype)}


def conv2d(params: dict, x: torch.Tensor, stride: Tuple[int, int],
           padding: str = "SAME",
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [B, H(time), W(freq), C] NHWC -> clipped-ReLU conv output
    [B, H', W', O]: the bias added in float32, clipped to [0, 20], then
    emitted at compute_dtype (float32 without one)."""
    w = params["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = conv_mixed(x, w, stride, padding)
    y = (y + params["b"].float()).clamp_(0.0, 20.0)
    return y if compute_dtype is None else y.to(compute_dtype)
