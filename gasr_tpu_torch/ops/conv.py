"""Convolutions with the JAX package's layouts (`gasr_tpu/ops/conv.py`):
channels-last input (NHWC, or NWC in 1-D) and HWIO (WIO) weights at the
public functions, torch's channels-first layout only inside.

Padding follows lax exactly. "SAME" gives out = ceil(n / s) and pads
max((out - 1) * s + k - n, 0) in all, the lower half (rounded down)
before and the rest after: for k = 3, s = 2 on an even n that is (0, 1),
which `F.conv2d(padding=1)` would not reproduce, so the pad is explicit.

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

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.linear import uniform_init


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax "SAME" padding (lo, hi) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_mixed(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
               padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """Forward of the JAX package's `conv_mixed` with "SAME" padding (the
    only padding its ported callers use): x [B, *spatial, C] (channels
    last), w [*kernel, C // groups, O] -> float32 [B, *spatial', O], with
    the products summed in float32 at the operands' dtype (see the
    module docstring)."""
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError(
            "conv_mixed is forward only (its VJP comes with training, "
            "ROADMAP.md Queue 1 item 12)")
    n = x.ndim - 2
    if n not in (1, 2) or w.ndim != n + 2:
        raise ValueError(f"conv_mixed: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not a 1-D or 2-D conv")
    if padding != "SAME":
        raise ValueError(f"conv_mixed: padding {padding!r} is not ported "
                         "(only 'SAME')")
    pads = [same_pads(x.shape[1 + i], w.shape[i], stride[i])
            for i in range(n)]
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


def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                kernel: Tuple[int, int], device="cpu") -> dict:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) HWIO weight and bias."""
    bound = (1.0 / (in_ch * kernel[0] * kernel[1])) ** 0.5
    return {"w": uniform_init(generator, tuple(kernel) + (in_ch, out_ch),
                              bound, device),
            "b": uniform_init(generator, (out_ch,), bound, device)}


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
