"""Rel-pos multi-head self-attention with no O(T^2) tensor in device memory.

Replaces `gasr_tpu/ops/pallas/flash_mhsa.py::flash_mhsa_rel` (kernel body
`_kernel`). Per (batch, head) it computes Transformer-XL attention with
the sinusoid position bias factorized by angle addition, which removes
the rel-shift:

    bd[t, s] = cos(w s) . A(t) + sin(w s) . B(t)
    A(t) = us(t) sin(w t) + uc(t) cos(w t)
    B(t) = uc(t) sin(w t) - us(t) cos(w t)

with us = (q + vb) @ ws_h and uc = (q + vb) @ wc_h, ws / wc the rows of
`wr` that weight the sin / cos halves of the sinusoid basis, per head.
The scores (q + u) k^T + bd are scaled by 1/sqrt(dh), keys at or past
lengths[b] are masked, the float32 softmax is rounded to bf16 and
multiplied by v.

Rounding points (those of the JAX package's `flash_ref`): q, k, v, wr,
u and vb are bf16; q + u and q + vb are bf16 sums; every product is
summed in float32; us and uc are rounded to bf16, every elementwise
product and sum forming A and B is rounded to bf16; the normalized
attention is rounded to bf16 before its product with v.

`flash_mhsa_rel` launches the CUDA kernel (`csrc/flash_mhsa.cu`) for CUDA
tensors and runs `flash_mhsa_rel_plain` for CPU tensors. It is forward
only: inputs that require grad raise (the backward comes with training,
ROADMAP.md Queue 1 item 12).

lengths: a length of 0 masks every key; then the kernel and the plain
version both average v over the T keys, as `flash_ref` does (the JAX
kernel averages over its padded key count instead). Lengths above T act
as T.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.cuda import _lib

NEG = -1e30

# kernel launches made by flash_mhsa_rel (one per call)
launches = 0


def flash_eligible(T: int, dh: int, D: int) -> bool:
    """The JAX package's dispatch rule (`flash_mhsa.py::flash_eligible`):
    2 <= T <= 1024, dh <= 128, D split into sin / cos halves."""
    return 2 <= T <= 1024 and dh <= 128 and D % 2 == 0


def _tables(T: int, D: int, device) -> tuple:
    """cos(w_i t), sin(w_i t) for t in [0, T), i < D/2: [T, D/2] bf16, with
    the float32 expressions of `flash_ref`."""
    inv = torch.exp(-torch.arange(0, D, 2, dtype=torch.float32, device=device)
                    * (math.log(10000.0) / D))
    ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)


def _head_weights(wr: torch.Tensor, H: int, dh: int) -> tuple:
    """wr [D, D] -> ws, wc [H, dh, D/2] bf16: rows 0..D/2-1 of wr weight
    the sin block of the basis, rows D/2.. the cos block
    (`ops/attention.py::_sinusoid_pos`'s order)."""
    D = H * dh
    half = D // 2
    wrh = wr.to(torch.bfloat16).reshape(D, H, dh)
    return (wrh[:half].permute(1, 2, 0), wrh[half:2 * half].permute(1, 2, 0))


def flash_mhsa_rel_plain(q, k, v, wr, u, vb, lengths,
                         out_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch version, a port of `flash_ref`: the same factorized
    math with bf16 operands rounded first and fed to float32 products
    (exact products, float32 sums)."""
    B, H, T, dh = q.shape
    D = H * dh
    bf, f32 = torch.bfloat16, torch.float32
    mx = lambda a: a.to(bf).float()                     # noqa: E731
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=f32))
    qb, kb, vbf = q.to(bf), k.to(bf), v.to(bf)
    qu = mx(qb + u.to(bf)[None, :, None, :])
    qv = mx(qb + vb.to(bf)[None, :, None, :])
    ac = torch.matmul(qu, mx(kb).transpose(-1, -2))     # [B, H, T, S]
    ws, wc = _head_weights(wr, H, dh)
    us = torch.matmul(qv, mx(ws)[None])                 # [B, H, T, half]
    uc = torch.matmul(qv, mx(wc)[None])
    cs, sn = _tables(T, D, q.device)
    usb, ucb = us.to(bf), uc.to(bf)
    A = mx(usb * sn + ucb * cs)
    Bm = mx(ucb * sn - usb * cs)
    bd = (torch.matmul(A, cs.float().transpose(0, 1))
          + torch.matmul(Bm, sn.float().transpose(0, 1)))
    scores = (ac + bd) * scale
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])            # [B, S]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG, dtype=f32, device=q.device))
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(mx(attn), mx(vbf))
    return out if out_f32 else out.to(bf)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_mhsa_rel(q, k, v, wr, u, vb, lengths,
                   out_f32: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, T, dh] (any float dtype; bf16 inside), wr: [D, D]
    (D = H * dh), u, vb: [H, dh], lengths: [B] valid key counts. Returns
    [B, H, T, dh], float32 when out_f32 else bf16."""
    if any(t.requires_grad for t in (q, k, v, wr, u, vb)):
        raise NotImplementedError(
            "flash_mhsa_rel is forward only (the backward comes with "
            "training, ROADMAP.md Queue 1 item 12)")
    if q.device.type == "cpu":
        return flash_mhsa_rel_plain(q, k, v, wr, u, vb, lengths, out_f32)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mhsa_rel: unsupported device {q.device}")
    if q.ndim != 4:
        raise ValueError(f"flash_mhsa_rel: q must be [B, H, T, dh], got "
                         f"{tuple(q.shape)}")
    B, H, T, dh = q.shape
    D = H * dh
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError("flash_mhsa_rel: q, k, v shapes differ")
    if tuple(wr.shape) != (D, D) or tuple(u.shape) != (H, dh) or \
            tuple(vb.shape) != (H, dh) or tuple(lengths.shape) != (B,):
        raise ValueError("flash_mhsa_rel: wr, u, vb or lengths do not fit "
                         f"q {tuple(q.shape)}")
    if not flash_eligible(T, dh, D):
        raise ValueError(f"flash_mhsa_rel: T={T}, dh={dh}, D={D} is outside "
                         "flash_eligible (2 <= T <= 1024, dh <= 128, D even)")
    for t in (k, v, wr, u, vb, lengths):
        if t.device != q.device:
            raise ValueError("flash_mhsa_rel: all tensors must be on one "
                             "device")
    if B == 0 or H == 0:
        return torch.empty(q.shape, device=q.device,
                           dtype=torch.float32 if out_f32 else torch.bfloat16)
    # zero padding: T to a multiple of 16 (padded keys are left out of the
    # softmax, padded queries dropped), dh and D/2 to multiples of 16 (zero
    # terms in every sum)
    half = D // 2
    Tp, dhp, halfp = _round_up(T, 16), _round_up(dh, 16), _round_up(half, 16)
    bf = torch.bfloat16

    def pad_qkv(a):
        return F.pad(a.to(bf), (0, dhp - dh, 0, Tp - T)).contiguous()

    qp, kp, vp = pad_qkv(q), pad_qkv(k), pad_qkv(v)
    ws, wc = _head_weights(wr, H, dh)
    wpad = (0, halfp - half, 0, dhp - dh)
    ws = F.pad(ws, wpad).contiguous()
    wc = F.pad(wc, wpad).contiguous()
    cs, sn = _tables(Tp, D, q.device)
    cs = F.pad(cs, (0, halfp - half)).contiguous()
    sn = F.pad(sn, (0, halfp - half)).contiguous()
    up = F.pad(u.to(bf), (0, dhp - dh)).contiguous()
    vbp = F.pad(vb.to(bf), (0, dhp - dh)).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, T, dh), device=q.device,
                      dtype=torch.float32 if out_f32 else bf)
    lib = _lib.load("flash_mhsa")
    err = lib.flash_mhsa_rel_launch(
        _lib.ptr(qp), _lib.ptr(kp), _lib.ptr(vp), _lib.ptr(ws), _lib.ptr(wc),
        _lib.ptr(cs), _lib.ptr(sn), _lib.ptr(up), _lib.ptr(vbp),
        _lib.ptr(lens), B, H, T, dh, Tp, dhp, halfp,
        ctypes.c_float(1.0 / math.sqrt(dh)), int(out_f32), _lib.ptr(out),
        _lib.stream(q.device))
    # the launcher picks the query tile whose shared memory fits a block
    # and refuses (cudaErrorInvalidValue, 1) when none does: T near 1024
    # with D above ~4000
    _lib.check(err, "flash_mhsa_rel")
    global launches
    launches += 1
    return out
