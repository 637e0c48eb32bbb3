"""wav2vec 2.0's positional convolution with its bias and GELU:
`csrc/pos_conv.cu`, one launch a forward on the bf16 serving path.

For h [B, T, C], w [K, 64, C] (WIO: C / 64 groups of 64 channels in and
out) and b [C], with lo = K // 2 frames of zero padding before h:

    s   = bf16(sum_k sum_c h[:, t + k - lo, 64 g + c] w[k, c, 64 g + o])
    y   = bf16(s + b)                       (the eager `.add_(b)`)
    out = F.gelu(y) (act "gelu") | y (act "none"),   t < T

the model's eager chain (`models/wav2vec2.py`): `conv1d_nwc` padded by
(lo, lo), `.add_(b)`, the slice to T frames (an even K makes one more),
F.gelu. Replaces no Pallas kernel: the family has no JAX counterpart.
`pos_conv_plain` is the same function as eager PyTorch in the kernel's
order (a float32 sum over the taps, rounded once); the CPU tests and
`chip_smoke.py` hold the kernel and the eager chain to it.

`pos_conv` launches the kernel for CUDA tensors and raises on what it
does not take (`_takes`) and under autograd (it has no backward).
`pos_conv_eligible` is the model's rule, `conv_gelu` the model's choice
between the kernel and the eager chain. `launches` counts launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.conv import conv1d_nwc
from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by pos_conv (one a call)
launches = 0

# the channels of a group, in and out, that the kernel is built for
WIDTH = 64
# the most taps whose input window fits the kernel's shared memory
# (csrc/pos_conv.cu's kMaxTaps)
MAX_TAPS = 512
# the forms after the bias add: csrc/pos_conv.cu's `act`
ACTS = {"none": 0, "gelu": 1}

_entry = None


def pos_conv_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   act: str = "gelu") -> torch.Tensor:
    """The kernel's function in eager PyTorch: the float32 sum of the K
    taps' grouped products (exact products of h's and w's values), rounded
    to h's dtype once, b added at h's dtype, then `act`."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    B, T, C = h.shape
    K, cg, _ = w.shape
    G, lo = C // cg, K // 2
    x = F.pad(h.float(), (0, 0, lo, K - 1 - lo)).view(B, T + K - 1, G, cg)
    wg = w.float().view(K, cg, G, cg)                     # [K, c, g, o]
    s = torch.zeros(B, T, G, cg, device=h.device)
    for k in range(K):
        s += torch.einsum("btgc,cgo->btgo", x[:, k:k + T], wg[k])
    y = s.view(B, T, C).to(h.dtype).add_(b.to(h.dtype))
    return F.gelu(y) if act == "gelu" else y


def _takes(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
           groups: int) -> Optional[str]:
    """Why the kernel does not take these inputs, or None."""
    if stride != 1:
        return f"stride must be 1, got {stride}"
    if h.dtype != torch.bfloat16 or h.ndim != 3 or h.numel() == 0:
        return (f"h must be bf16 [B, T, C] with B, T >= 1, got {h.dtype} "
                f"{tuple(h.shape)}")
    C = h.shape[2]
    if groups <= 0 or C != WIDTH * groups:
        return (f"each of the {groups} groups must have {WIDTH} channels, "
                f"got C = {C}")
    if (w.dtype != torch.bfloat16 or w.ndim != 3
            or tuple(w.shape[1:]) != (WIDTH, C)
            or not 1 <= w.shape[0] <= MAX_TAPS):
        return (f"w must be bf16 [K, {WIDTH}, {C}] with 1 <= K <= "
                f"{MAX_TAPS}, got {w.dtype} {tuple(w.shape)}")
    if b.dtype != torch.bfloat16 or tuple(b.shape) != (C,):
        return f"b must be bf16 [{C}], got {b.dtype} {tuple(b.shape)}"
    if not h.is_contiguous():
        return f"h must be contiguous, strides {h.stride()}"
    if w.device != h.device or b.device != h.device:
        return (f"h, w and b must be on one device, got {h.device}, "
                f"{w.device}, {b.device}")
    return None


def _records(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def pos_conv_eligible(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      stride: int, groups: int) -> bool:
    """The model's rule: a bf16 CUDA h with groups of 64 channels in and
    out, stride 1, at most MAX_TAPS taps, and autograd not recording."""
    return (h.is_cuda and not _records(h, w, b)
            and _takes(h, w, b, stride, groups) is None)


def _launch(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            act: str) -> torch.Tensor:
    global _entry, launches
    if _entry is None:
        _entry = _lib.load("pos_conv").pos_conv_launch
    B, T, C = h.shape
    K = w.shape[0]
    if K % 2:                        # the kernel takes taps two at a time
        w = F.pad(w, (0, 0, 0, 0, 0, 1))
    Kp = w.shape[0]
    # [Kp, 64, C] -> [G][Kp][8][64 o][8 c]: each tap's 64 x 64 block in the
    # tensor cores' layout, a group's taps contiguous
    wp = w.reshape(Kp, 8, 8, C // WIDTH, WIDTH).permute(3, 0, 1, 4, 2)
    wp = wp.contiguous()
    b = b.contiguous()
    out = torch.empty_like(h)
    dev = h.device.index
    _lib.check(_entry(h.data_ptr(), wp.data_ptr(), b.data_ptr(),
                      out.data_ptr(), B, T, C, Kp, K // 2, ACTS[act], dev,
                      torch.cuda.current_stream(dev).cuda_stream),
               "pos_conv (pos_conv_kernel)")
    launches += 1
    return out


def pos_conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             act: str = "gelu") -> torch.Tensor:
    """`pos_conv_plain(h, w, b, act)` for bf16 CUDA tensors, in one launch
    (see the module docstring)."""
    if not h.is_cuda:
        raise ValueError(f"pos_conv: h must be a CUDA tensor, got one on "
                         f"{h.device}")
    if act not in ACTS:
        raise ValueError(f"pos_conv: act must be one of {sorted(ACTS)}, "
                         f"got {act!r}")
    why = _takes(h, w, b, 1, h.shape[-1] // WIDTH if h.ndim == 3 else 0)
    if why is not None:
        raise ValueError(f"pos_conv: {why}")
    if _records(h, w, b):
        raise NotImplementedError(
            "pos_conv is forward only: under autograd the model takes the "
            "eager chain")
    return _launch(h, w, b, act)


def conv_gelu(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              groups: int) -> torch.Tensor:
    """F.gelu(conv(h, w) + b) over h's T frames, zero padding of K // 2
    before and after, w and b at h's dtype: the kernel where
    `pos_conv_eligible` holds, the eager chain (`conv1d_nwc`, `.add_(b)`,
    the slice, F.gelu) elsewhere."""
    if pos_conv_eligible(h, w, b, 1, groups):
        return _launch(h, w, b, "gelu")
    K, T = w.shape[0], h.shape[1]
    y = conv1d_nwc(h, w, 1, (K // 2, K // 2), groups).add_(b)
    return F.gelu(y[:, :T])
