"""Fused conformer subsampling stem: conv1 + bias + clip, conv2 + bias +
clip -> bf16, freq-major `sub_proj` + bias, from x, with conv1's output
kept out of device memory.

Replaces `gasr_tpu/ops/pallas/stem.py::fused_stem` (kernel body
`_kernel`, fed by `_conv1_planes`):

    h1 = bf16(clip(conv1(bf16(x)) + b1, 0, 20))          [B, T/2, F/2, d]
    out[b, t2] = bp + sum_f2 bf16(clip(b2 + sum_{di,dj} h1[b, 2 t2 + di,
                 2 f2 + dj] . w2[di, dj], 0, 20)) . wp[f2]

(3x3 taps at stride 2; lax "SAME" pads the high edge, so conv1's taps at
x row T or column F and conv2's at h1 row T/2 or column F/2 read zero).

On the card a call is two kernels of `csrc/stem.cu` on the current
stream: `stem_conv_kernel` computes h1 inside the kernel from x (read
through its strides, no copy; a dtype other than float32 is converted
first), one 32-channel chunk of the tile's h1 region at a time in shared
memory, and conv2 as an implicit GEMM over it, writing h2 [B, T/4, F/4,
d] bf16 to a scratch tensor (conv2's columns in `f2_windows` windows of
at most WINDOW_MAX, so that a block's shared memory is the same at any
F); `stem_proj_kernel` multiplies h2, seen as
[B T/4, (F/4) d], by wp and adds bp. No cuDNN or cuBLAS call; besides the
kernels the wrapper only casts the weights to bf16 and lays w2 and wp
out as the blocks the kernels copy in bulk (`conv_w2_stages`,
`proj_wp_stages`: 15 MB at conformer_l).
The JAX kernel's parity planes of h1 (a Mosaic work-around for strided
access, computed by XLA) are not carried over.

Rounding: bf16 operands, float32 sums. The biases follow `stem_ref`, the
JAX package's oracle: b1 and b2 are added in float32 and bp is rounded
to bf16 (`linear` at bf16 rounds its bias); the JAX kernel rounds b2 and
bp to bf16. Unlike the plain version on the card (cuDNN rounds conv1's
sum to bf16 before the bias, `ops/conv.py`), the kernel adds b1 to the
float32 sum, as `stem_ref` does.

`fused_stem` launches the kernels for CUDA tensors and runs
`fused_stem_plain` for CPU tensors. It is differentiable, as the JAX
package's custom_vjp is: an autograd Function saves the primals and its
backward is the VJP of `fused_stem_plain` (`stem_ref`) at them, so the
kernels' output never reaches a gradient. `launches` counts calls on the
card (two kernel launches each).
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.ops.conv import conv2d
from gasr_tpu_torch.ops.cuda import _lib
from gasr_tpu_torch.ops.linear import linear

# fused_stem calls on the card (each launches stem_conv_kernel and
# stem_proj_kernel)
launches = 0

# K slice of the kernels' weight blocks (csrc/stem.cu); the most f2
# columns of a window of the conv kernel (csrc/stem.cu's kWindowMax)
_CK = 32
WINDOW_MAX = 24


def f2_windows(F2: int) -> int:
    """How many windows of consecutive f2 columns the conv kernel cuts
    conv2's F2 columns into: the fewest of at most WINDOW_MAX columns,
    F2 // NW or F2 // NW + 1 each (at least 2 each, since F2 >= 2)."""
    return -(-F2 // WINDOW_MAX)


def stem_eligible(T: int, F: int, d: int, dout: int) -> bool:
    """The JAX package's dispatch rule (`stem.py::stem_eligible`): raw
    input time T and freq F split evenly through both stride-2 stages,
    channel widths multiples of 128, d <= 1024."""
    return (T % 4 == 0 and F % 4 == 0 and T >= 8 and F >= 8
            and d % 128 == 0 and dout % 128 == 0 and d <= 1024)


def conv_tile_n(d: int) -> int:
    """Output channels of a stem_conv_kernel block."""
    return 128 if d % 256 else 256


def _swizzled_blocks(w: torch.Tensor, K: int, N: int,
                     BN: int) -> torch.Tensor:
    """[K, N] -> [N / BN, K / 32, BN, 32] bf16: for each column tile and
    32-deep K slice, the kernels' B block in the tensor cores' 64-byte
    swizzle (K-major): row n holds its 32 k as four 16-byte chunks, chunk
    c stored at c ^ ((n % 8) / 2); one block a bulk copy."""
    blk = w.to(torch.bfloat16).reshape(K // _CK, 4, 8, N // BN, BN).permute(
        3, 0, 4, 1, 2)                     # [nt, ks, n, chunk, 8]
    n = torch.arange(BN, device=w.device)[:, None]
    src = torch.arange(4, device=w.device)[None, :] ^ (n % 8 // 2)
    idx = src[None, None, :, :, None].expand(*blk.shape)
    return blk.gather(3, idx).reshape(N // BN, K // _CK, BN, _CK).contiguous()


def conv_w2_stages(w2: torch.Tensor) -> torch.Tensor:
    """w2 [3, 3, d, d] (HWIO) -> the conv kernel's staged w2, bf16
    [d / BN, d / 32, 9, BN, 32]: stage (column tile nt, chunk cc, tap
    3 di + dj) is w2[di, dj, 32 cc .., BN nt ..] swizzled
    (`_swizzled_blocks`); stages in the kernel's order (chunk, then
    tap)."""
    d = w2.shape[-1]
    BN, nc = conv_tile_n(d), d // _CK
    st = _swizzled_blocks(w2.reshape(9, d, d).permute(1, 0, 2).reshape(
        d, 9 * d), d, 9 * d, BN)           # [9 nN, nc, ...]: n = tap d + c
    # columns are (tap, column tile): regroup to column tile, chunk, tap
    return st.reshape(9, d // BN, nc, BN, _CK).permute(1, 2, 0, 3,
                                                        4).contiguous()


def proj_wp_stages(wp: torch.Tensor) -> torch.Tensor:
    """wp [K, dout] -> the sub_proj kernel's staged wp, bf16: stage
    (column tile, K slice) swizzled (`_swizzled_blocks`)."""
    K, dout = wp.shape
    return _swizzled_blocks(wp, K, dout, 128 if dout % 256 else 256)


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


def _stem_forward(x, w1, b1, w2, b2, wproj, bproj,
                  out_dtype) -> torch.Tensor:
    """The forward of `fused_stem`: the kernels on CUDA tensors, the plain
    version on CPU tensors."""
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
    lib = _lib.load("stem")
    bf = torch.bfloat16
    if x.dtype != torch.float32:
        x = x.float()                                   # else read in place
    w1k = torch.zeros((d, 16), device=x.device, dtype=bf)
    w1k[:, :9] = w1.reshape(9, d).t()                   # [c, tap], 0-padded
    w2k = conv_w2_stages(w2)
    wpk = proj_wp_stages(wproj)
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    bpf = bproj.to(bf).float().contiguous()
    out = torch.empty((B, T2, dout), device=x.device, dtype=out_dtype)
    if B == 0:
        return out
    h2 = torch.empty((B, T2, F2, d), device=x.device, dtype=bf)
    stream = _lib.stream(x.device)
    _lib.check(lib.stem_conv_launch(
        _lib.ptr(x), *x.stride(), _lib.ptr(w1k), _lib.ptr(b1f),
        _lib.ptr(w2k), _lib.ptr(b2f), _lib.ptr(h2), B, T, Fr, d,
        f2_windows(F2), stream),
        "fused_stem (stem_conv_kernel)")
    _lib.check(lib.stem_proj_launch(
        _lib.ptr(h2), _lib.ptr(wpk), _lib.ptr(bpf), B * T2, F2 * d, dout,
        int(out_dtype == torch.float32), _lib.ptr(out), stream),
        "fused_stem (stem_proj_kernel)")
    global launches
    launches += 1
    return out


def fused_stem_vjp(x, w1, b1, w2, b2, wproj, bproj, g,
                   out_dtype=torch.bfloat16, needs=(True,) * 7) -> tuple:
    """The backward of `fused_stem` (the JAX package's `_stem_core_bwd`):
    the VJP of `fused_stem_plain` at the primals for the cotangent g; the
    grads of (x, w1, b1, w2, b2, wproj, bproj) at their dtypes, None
    where `needs` says no."""
    with torch.enable_grad():
        prim = [t.detach().requires_grad_(n)
                for t, n in zip((x, w1, b1, w2, b2, wproj, bproj), needs)]
        out = fused_stem_plain(*prim, out_dtype=out_dtype)
        grads = iter(torch.autograd.grad(
            out, [p for p in prim if p.requires_grad], g))
    return tuple(next(grads) if n else None for n in needs)


class _FusedStem(torch.autograd.Function):
    """The JAX package's `_stem_core` custom_vjp: the kernels' forward,
    the recompute backward (`fused_stem_vjp`) from the saved primals."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wproj, bproj, out_dtype):
        ctx.save_for_backward(x, w1, b1, w2, b2, wproj, bproj)
        ctx.out_dtype = out_dtype
        return _stem_forward(x, w1, b1, w2, b2, wproj, bproj, out_dtype)

    @staticmethod
    def backward(ctx, g):
        grads = fused_stem_vjp(*ctx.saved_tensors, g,
                               out_dtype=ctx.out_dtype,
                               needs=ctx.needs_input_grad[:7])
        return (*grads, None)


def fused_stem(x, w1, b1, w2, b2, wproj, bproj,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, T, F] float; w1 [3, 3, 1, d], b1 [d]; w2 [3, 3, d, d] (HWIO),
    b2 [d]; wproj [(F/4) * d, dout] (rows freq-major, f2 * d + c), bproj
    [dout] -> [B, T/4, dout] at out_dtype (bf16 or float32).
    Differentiable (`fused_stem_vjp`)."""
    return _FusedStem.apply(x, w1, b1, w2, b2, wproj, bproj, out_dtype)
