"""Fused conformer subsampling stem: conv2 + bias + clip -> bf16 ->
freq-major `sub_proj` + bias, over conv1's output, with conv2's output
kept out of device memory.

Replaces `gasr_tpu/ops/pallas/stem.py::fused_stem` (kernel body
`_kernel`). From h1 = bf16(clip(conv1(x) + b1, 0, 20)) [B, T/2, F/2, d]:

    out[b, t2] = bp + sum_f2 bf16(clip(b2 + sum_{di,dj} h1[b, 2 t2 + di,
                 2 f2 + dj] . w2[di, dj], 0, 20)) . wp[f2]

(3x3 taps at stride 2; lax "SAME" pads the high edge, so taps at
2 t2 + 2 = T/2 or 2 f2 + 2 = F/2 read zero). conv1 stays outside the
kernel, as in the JAX package where XLA computes it: `ops/conv.py::conv2d`
at bf16 (cuDNN on the card). The JAX kernel's parity-plane decomposition
of h1 works around strided access in Mosaic and is not carried over: the
CUDA kernel reads h1 at stride 2 directly.

Rounding: bf16 operands, float32 sums. The biases follow `stem_ref`, the
JAX package's oracle: b2 is added in float32 and bp is rounded to bf16
(`linear` at bf16 rounds its bias); the JAX kernel rounds both to bf16.

`fused_stem` launches the CUDA kernel (`csrc/stem.cu`) for CUDA tensors
and runs `fused_stem_plain` for CPU tensors. Forward only: inputs that
require grad raise (the backward comes with training, ROADMAP.md Queue 1
item 12).
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.ops.conv import conv2d
from gasr_tpu_torch.ops.cuda import _lib
from gasr_tpu_torch.ops.linear import linear

# kernel launches made by fused_stem (one per call)
launches = 0


def stem_eligible(T: int, F: int, d: int, dout: int) -> bool:
    """The JAX package's dispatch rule (`stem.py::stem_eligible`): raw
    input time T and freq F split evenly through both stride-2 stages,
    channel widths multiples of 128, d <= 1024."""
    return (T % 4 == 0 and F % 4 == 0 and T >= 8 and F >= 8
            and d % 128 == 0 and dout % 128 == 0 and d <= 1024)


def fused_stem_plain(x, w1, b1, w2, b2, wproj, bproj,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version, a port of `stem_ref`: conv2d + conv2d at
    bf16, the freq-major flatten, `sub_proj` at bf16."""
    bf = torch.bfloat16
    h = conv2d({"w": w1, "b": b1}, x[..., None], (2, 2), compute_dtype=bf)
    h = conv2d({"w": w2, "b": b2}, h, (2, 2), compute_dtype=bf)
    B, T2, F2, d = h.shape
    h = h.reshape(B, T2, F2 * d)
    y = linear({"w": wproj, "b": bproj}, h, None, bf)
    return y.to(out_dtype)


def fused_stem(x, w1, b1, w2, b2, wproj, bproj,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, T, F] float; w1 [3, 3, 1, d], b1 [d]; w2 [3, 3, d, d] (HWIO),
    b2 [d]; wproj [(F/4) * d, dout] (rows freq-major, f2 * d + c), bproj
    [dout] -> [B, T/4, dout] at out_dtype (bf16 or float32)."""
    if any(t.requires_grad for t in (x, w1, b1, w2, b2, wproj, bproj)):
        raise NotImplementedError(
            "fused_stem is forward only (the backward comes with training, "
            "ROADMAP.md Queue 1 item 12)")
    if x.device.type == "cpu":
        return fused_stem_plain(x, w1, b1, w2, b2, wproj, bproj, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"fused_stem: x must be [B, T, F], got "
                         f"{tuple(x.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_stem: out_dtype {out_dtype} is not bf16 or "
                         "float32")
    B, T, Fr = x.shape
    d, dout = w2.shape[-1], wproj.shape[-1]
    if not stem_eligible(T, Fr, d, dout):
        raise ValueError(f"fused_stem: T={T}, F={Fr}, d={d}, dout={dout} is "
                         "outside stem_eligible")
    if dout > 1024:
        raise ValueError(f"fused_stem: the kernel takes dout <= 1024, got "
                         f"{dout}")
    T2, F2 = T // 4, Fr // 4
    if tuple(w1.shape) != (3, 3, 1, d) or tuple(w2.shape) != (3, 3, d, d) \
            or tuple(wproj.shape) != (F2 * d, dout) or b1.shape[-1] != d \
            or b2.shape[-1] != d or bproj.shape[-1] != dout:
        raise ValueError("fused_stem: weight shapes do not fit x "
                         f"{tuple(x.shape)} and d={d}")
    for t in (w1, b1, w2, b2, wproj, bproj):
        if t.device != x.device:
            raise ValueError("fused_stem: all tensors must be on one device")
    bf = torch.bfloat16
    h1 = conv2d({"w": w1, "b": b1}, x[..., None], (2, 2),
                compute_dtype=bf).contiguous()          # [B, T/2, F/2, d]
    w2k = w2.to(bf).reshape(9, d, d).contiguous()       # [tap, c_in, c_out]
    wpk = wproj.to(bf).contiguous()
    b2f = b2.float().contiguous()
    bpf = bproj.to(bf).float().contiguous()
    out = torch.empty((B, T2, dout), device=x.device, dtype=out_dtype)
    if B == 0:
        return out
    lib = _lib.load("stem")
    err = lib.fused_stem_launch(
        _lib.ptr(h1), _lib.ptr(w2k), _lib.ptr(b2f), _lib.ptr(wpk),
        _lib.ptr(bpf), B, T // 2, Fr // 2, d, dout,
        int(out_dtype == torch.float32), _lib.ptr(out), _lib.stream(x.device))
    _lib.check(err, "fused_stem")
    global launches
    launches += 1
    return out
