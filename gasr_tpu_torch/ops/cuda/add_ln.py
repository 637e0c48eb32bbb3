"""The conformer block's residual add and the LayerNorm after it:
`csrc/add_ln.cu`, one launch a call, on the bf16 inference path.

    x' = x + s * y          (y first rounded to x's dtype; x' = x without y)
    h  = LN(x')             (float32 statistics, eps 1e-5, gain g, bias b)

Replaces no Pallas kernel: the JAX package's `_ln` is plain jnp
(`gasr_tpu/models/conformer.py`). `add_ln_plain` is the port's eager
version, the same expressions as the model's float32, autograd and CPU
path (`models/conformer.py::_add_ln`); `ln_plain` is its LayerNorm.

`add_ln` launches the kernel for CUDA tensors: x bf16 [..., d] (2-D or
3-D, unit stride in d, the leading dims through any strides: the
residual stream's transposed [T, B, d] view is read in place), y None or
bf16 / float32 of x's shape, g and b float32 [d]; it returns x' (None
where `keep` is False, or x itself without y) and h, both contiguous bf16
of x's shape. It raises on what the kernel does not take, and for inputs
that require grad while autograd records (the kernel has no backward).
`add_ln_eligible` is the model's rule for taking it. `launches` counts
launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by add_ln (one a call)
launches = 0

# csrc/add_ln.cu: d a multiple of 8, at most 4 chunks of 8 a lane (the
# row in registers; the conformer presets' widths are 144, 512 and 1024)
MAX_D = 1024

_entry = None


def ln_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """LayerNorm with float32 statistics; the output keeps x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5) * g + b
    return y.to(x.dtype)


def add_ln_plain(x: torch.Tensor, y: Optional[torch.Tensor], s: float,
                 g: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x', LN(x')) with x' = x + s * y.to(x.dtype), or x without y."""
    if y is not None:
        t = y.to(x.dtype)
        x = x + (t if s == 1 else s * t)
    return x, ln_plain(x, g, b)


def _rows_aligned(t: torch.Tensor) -> bool:
    """16-byte loads reach every row of a 2-D or 3-D t: unit stride in
    the last dim, the address and the leading strides (of dims of more
    than one) in whole 16 bytes. Written out for the launch's host time."""
    st, sh = t.stride(), t.shape
    n = 16 // t.element_size()
    return (st[-1] == 1 and t.data_ptr() % 16 == 0
            and (st[0] % n == 0 or sh[0] == 1)
            and (len(st) == 2 or st[1] % n == 0 or sh[1] == 1))


def _takes_shape(x: torch.Tensor) -> bool:
    return x.ndim in (2, 3) and 0 < x.shape[-1] <= MAX_D and \
        x.shape[-1] % 8 == 0


def _takes(x: torch.Tensor, y: Optional[torch.Tensor], g: torch.Tensor,
           b: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take these inputs, or None."""
    if not _takes_shape(x):
        return (f"x must be [rows, d] or [n0, n1, d] with d a multiple of 8 "
                f"up to {MAX_D}, got {tuple(x.shape)}")
    d = x.shape[-1]
    if not _rows_aligned(x):
        return f"x's rows must be 16-byte aligned, strides {x.stride()}"
    if y is not None:
        if y.dtype not in (torch.bfloat16, torch.float32) or \
                y.shape != x.shape or y.device != x.device:
            return (f"y must be bf16 or float32 {tuple(x.shape)} on "
                    f"{x.device}, got {y.dtype} {tuple(y.shape)} on "
                    f"{y.device}")
        if not _rows_aligned(y):
            return f"y's rows must be 16-byte aligned, strides {y.stride()}"
    for name, p in (("g", g), ("b", b)):
        if p.dtype != torch.float32 or p.shape != (d,) or \
                p.device != x.device or not p.is_contiguous() or \
                p.data_ptr() % 16:
            return (f"{name} must be float32 [{d}] on {x.device}, 16-byte "
                    f"aligned, got {p.dtype} {tuple(p.shape)}")
    return None


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def add_ln_eligible(x: torch.Tensor, y: Optional[torch.Tensor],
                    g: torch.Tensor, b: torch.Tensor) -> bool:
    """The model's rule: a bf16 CUDA x, autograd not recording, and a row
    width d the kernel takes (a multiple of 8 up to MAX_D). The layout is
    the caller's to give: unit stride in d."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and _takes_shape(x)
            and not _records(x, y, g, b))


def add_ln(x: torch.Tensor, y: Optional[torch.Tensor], s: float,
           g: torch.Tensor, b: torch.Tensor, keep: bool = True
           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """`add_ln_plain` on the card, in one launch (none for an empty x; see
    the module docstring)."""
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"add_ln: x must be a bf16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    why = _takes(x, y, g, b)
    if why is not None:
        raise ValueError(f"add_ln: {why}")
    if _records(x, y, g, b):
        raise NotImplementedError(
            "add_ln is forward only: under autograd the model takes "
            "add_ln_plain")
    global _entry, launches
    if _entry is None:
        _entry = _lib.load("add_ln").add_ln_launch
    if x.ndim == 2:
        n0, n1, (xs0, xs1) = x.shape[0], 1, (x.stride(0), 0)
    else:
        n0, n1, xs0, xs1 = x.shape[0], x.shape[1], x.stride(0), x.stride(1)
    h = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    xo = (torch.empty_like(h) if keep and y is not None else None)
    if y is None:
        ykind, ys0, ys1 = 0, 0, 0
    else:
        ykind = 1 if y.dtype == torch.bfloat16 else 2
        ys0, ys1 = (y.stride(0), 0) if y.ndim == 2 else y.stride()[:2]
    if x.numel() == 0:
        return (x if y is None else xo), h
    dev = x.device.index
    _lib.check(_entry(
        x.data_ptr(), xs0, xs1, None if y is None else y.data_ptr(), ys0, ys1,
        ykind, float(s), g.data_ptr(), b.data_ptr(),
        None if xo is None else xo.data_ptr(), h.data_ptr(), n0, n1,
        x.shape[-1], dev, torch.cuda.current_stream(dev).cuda_stream),
        "add_ln (add_ln_kernel)")
    launches += 1
    return (x if y is None else xo), h
