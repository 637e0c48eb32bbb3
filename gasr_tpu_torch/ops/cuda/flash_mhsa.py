"""Rel-pos multi-head self-attention with no O(T^2) tensor in device memory.

Replaces `gasr_tpu/ops/pallas/flash_mhsa.py::flash_mhsa_rel` (kernel body
`_kernel`). Per (batch, head) it computes Transformer-XL attention:

    scores[t, s] = ((q + u)_t . k_s + bd[t, s]) / sqrt(dh)
    bd[t, s] = (q + vb)_t . R_h[(T-1) - (t - s)],  R = sinusoid(T, D) @ wr

keys at or past lengths[b] are masked, and the float32 softmax is
multiplied by v.

Two forms of the same function:
  - `flash_mhsa_rel_plain`, the port of the JAX package's `flash_ref`,
    factorizes bd by angle addition, which removes the rel-shift:
        bd[t, s] = cos(w s) . A(t) + sin(w s) . B(t)
        A(t) = us(t) sin(w t) + uc(t) cos(w t)
        B(t) = uc(t) sin(w t) - us(t) cos(w t)
    with us = (q + vb) @ ws_h and uc = (q + vb) @ wc_h, ws / wc the rows
    of `wr` that weight the sin / cos halves of the sinusoid basis. Its
    rounding points are flash_ref's: q, k, v, wr, u and vb are bf16; q + u
    and q + vb are bf16 sums; every product is summed in float32; us and
    uc are rounded to bf16, every elementwise product and sum forming A
    and B is rounded to bf16; the normalized attention is rounded to bf16
    before its product with v.
  - the CUDA kernel (`csrc/flash_mhsa.cu`) reads bd from a band of R:
    R = bf16(sinusoid @ wr) is one tensor-core product here on bf16
    operands (the JAX package's XLA route computes the same product in
    float32; flash_ref rounds wr and its sinusoid tables to bf16), and
    the kernel's key-tile loop multiplies qv by a window of R rows and
    reads the product at the skewed offset. Its online softmax rounds
    the unnormalized probabilities to bf16 before the product with v.

The same file holds the position-free variant (`flash_mhsa`, kernel
`flash_mhsa_kernel`): scores (q . k) / sqrt(dh), no band, no u and vb,
the rest as above; `flash_mhsa_plain` is its eager twin (q, k, v rounded
to bf16, float32 products and softmax, the normalized attention rounded
to bf16 before its product with v). It is forward only: no model trains
through it yet, and `ops/attention.py::mhsa` takes the eager route
under autograd.

`flash_mhsa_rel` launches the kernel for CUDA tensors and runs
`flash_mhsa_rel_plain` for CPU tensors. It is differentiable, as the
JAX package's custom_vjp is: an autograd Function saves the primals (not
the output) and its backward, `flash_mhsa_rel_vjp`, is the VJP of
`flash_mhsa_rel_plain` at them, in batch chunks whose [Bc, H, T, T]
float32 score tile stays within `_BWD_SCORE_BYTES`. The kernel's output
therefore never reaches a gradient.

lengths: a length of 0 masks every key; then the kernel and the plain
version both average v over the T keys, as `flash_ref` does (the JAX
kernel averages over its padded key count instead). Lengths above T act
as T.
"""

from __future__ import annotations

import functools
import math

import torch

from gasr_tpu_torch.ops.cuda import _lib

NEG = -1e30

# kernel launches made by flash_mhsa_rel (one per call)
launches = 0
# kernel launches made by flash_mhsa, the position-free variant
position_free_launches = 0

# the largest [Bc, H, T, T] float32 score tile the recompute backward
# holds at once (the JAX package's value); larger batches run in chunks
_BWD_SCORE_BYTES = 48 * 2**20


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


@functools.lru_cache(maxsize=8)
def _pos_table(T: int, D: int, device) -> torch.Tensor:
    """The sinusoid embeddings of offsets T-1 .. -(T-1), [2T-1, D] bf16
    (`ops/attention.py::_sinusoid_pos`, rounded as `flash_ref` rounds its
    cos / sin tables), kept per (T, D, device)."""
    from gasr_tpu_torch.ops.attention import _sinusoid_pos
    return _sinusoid_pos(T, D, device).to(torch.bfloat16)


def _copy_width(dh: int, tensors) -> int:
    """The widest copy, in bf16 values (8, 4, 2 or 1), that divides dh,
    every stride and every pointer of `tensors`: the kernel stages its
    tiles by asynchronous copies of that many values."""
    g = math.gcd(dh, *(st for t in tensors for st in t.stride()[:-1]),
                 *(t.data_ptr() // 2 for t in tensors))
    return next(vec for vec in (8, 4, 2, 1) if g % vec == 0)


def _check_qkv(name: str, q, k, v, lengths) -> None:
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be [B, H, T, dh], got "
                         f"{tuple(q.shape)}")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"{name}: q, k, v shapes differ")
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"{name}: lengths must be [B], got "
                         f"{tuple(lengths.shape)}")


def _launch(name: str, q, k, v, lengths, out_f32: bool,
            band=None) -> torch.Tensor:
    """One launch on CUDA tensors: of `flash_mhsa_rel_kernel` when band is
    (wr, u, vb), of `flash_mhsa_kernel` when it is None. Returns
    [B, H, T, dh] as a view of a [T, B, H, dh] tensor."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_qkv(name, q, k, v, lengths)
    B, H, T, dh = q.shape
    D = H * dh
    if band is not None:
        wr, u, vb = band
        if tuple(wr.shape) != (D, D) or tuple(u.shape) != (H, dh) or \
                tuple(vb.shape) != (H, dh):
            raise ValueError(f"{name}: wr, u or vb do not fit q "
                             f"{tuple(q.shape)}")
    if not flash_eligible(T, dh, D):
        raise ValueError(f"{name}: T={T}, dh={dh}, D={D} is outside "
                         "flash_eligible (2 <= T <= 1024, dh <= 128, D even)")
    for t in (k, v, lengths, *(band or ())):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    out = torch.empty((T, B, H, dh), device=q.device,
                      dtype=torch.float32 if out_f32 else torch.bfloat16)
    if B == 0 or H == 0:
        return out.permute(1, 2, 0, 3)
    bf = torch.bfloat16

    def operand(a):
        # q, k, v are read through their strides: no copy for bf16 views
        a = a if a.dtype == bf else a.to(bf)
        return a if a.stride(-1) == 1 else a.contiguous()

    def f32(a):
        a = a if a.dtype == torch.float32 else a.float()
        return a if a.is_contiguous() else a.contiguous()

    qb, kb, vbf = operand(q), operand(k), operand(v)
    lens = lengths if lengths.dtype == torch.int32 and \
        lengths.is_contiguous() else lengths.to(torch.int32).contiguous()
    strides = (*qb.stride()[:3], *kb.stride()[:3], *vbf.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib.load("flash_mhsa")
    if band is None:
        err = lib.flash_mhsa_launch(
            qb.data_ptr(), kb.data_ptr(), vbf.data_ptr(), lens.data_ptr(),
            out.data_ptr(), B, H, T, dh, *strides, 1.0 / math.sqrt(dh),
            int(out_f32), _copy_width(dh, (qb, kb, vbf)), stream)
    else:
        # R = bf16(bf16(sinusoid) @ bf16(wr)): [2T-1, D], head h in columns
        # h*dh.., one tensor-core product (flash_ref's operand roundings)
        r = torch.matmul(_pos_table(T, D, q.device),
                         wr if wr.dtype == bf else wr.to(bf))
        u32, vb32 = f32(u), f32(vb)
        err = lib.flash_mhsa_rel_launch(
            qb.data_ptr(), kb.data_ptr(), vbf.data_ptr(), r.data_ptr(),
            u32.data_ptr(), vb32.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, T, dh, *strides, 1.0 / math.sqrt(dh), int(out_f32),
            _copy_width(dh, (qb, kb, vbf, r)), stream)
    _lib.check(err, name)
    return out.permute(1, 2, 0, 3)


def _flash_forward(q, k, v, wr, u, vb, lengths,
                   out_f32: bool) -> torch.Tensor:
    """The forward of `flash_mhsa_rel`: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_mhsa_rel_plain(q, k, v, wr, u, vb, lengths, out_f32)
    out = _launch("flash_mhsa_rel", q, k, v, lengths, out_f32, (wr, u, vb))
    global launches
    launches += 1
    return out


def flash_mhsa_plain(q, k, v, lengths, out_f32: bool = False
                     ) -> torch.Tensor:
    """The position-free attention in plain PyTorch: bf16 operands fed to
    float32 products, scores (q . k) / sqrt(dh), keys at or past
    lengths[b] masked (a length of 0 averages v over the T keys), the
    float32 softmax rounded to bf16 before its product with v."""
    _check_qkv("flash_mhsa_plain", q, k, v, lengths)
    B, H, T, dh = q.shape
    bf, f32 = torch.bfloat16, torch.float32
    mx = lambda a: a.to(bf).float()                     # noqa: E731
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=f32))
    scores = torch.matmul(mx(q), mx(k).transpose(-1, -2)) * scale
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])            # [B, S]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG, dtype=f32, device=q.device))
    out = torch.matmul(mx(torch.softmax(scores, dim=-1)), mx(v))
    return out if out_f32 else out.to(bf)


def flash_mhsa(q, k, v, lengths, out_f32: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, T, dh] (any float dtype, any strides; bf16 inside),
    lengths: [B] valid key counts. Returns [B, H, T, dh], float32 when
    out_f32 else bf16: on CUDA tensors one launch of `flash_mhsa_kernel`,
    whose output is a view of a [T, B, H, dh] tensor (the time-major
    caller reshapes it without a copy); `flash_mhsa_plain` on CPU
    tensors. Forward only: it raises for inputs that require grad while
    autograd records."""
    if q.device.type == "cpu":
        return flash_mhsa_plain(q, k, v, lengths, out_f32)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_mhsa is forward only")
    out = _launch("flash_mhsa", q, k, v, lengths, out_f32)
    global position_free_launches
    position_free_launches += 1
    return out


def flash_mhsa_rel_vjp(q, k, v, wr, u, vb, lengths, g,
                       out_f32: bool = False) -> tuple:
    """The backward of `flash_mhsa_rel` (the JAX package's
    `_flash_core_bwd`): the VJP of `flash_mhsa_rel_plain` at the primals
    for the cotangent g (cast to float32 when out_f32, else to bf16).
    Batches whose [B, H, T, T] float32 score tile passes
    `_BWD_SCORE_BYTES` run in equal batch chunks; q, k, v grads are
    concatenated, and wr, u, vb grads summed over the chunks in float32.
    Returns the grads of (q, k, v, wr, u, vb) at their dtypes."""
    B, H, T, dh = q.shape
    g = g.float() if out_f32 else g.to(torch.bfloat16)
    nchunks = min(B, max(1, -(-(B * H * T * T * 4) // _BWD_SCORE_BYTES)))
    while B % nchunks:
        nchunks += 1
    Bc = B // nchunks
    parts = []
    for i in range(nchunks):
        rows = slice(i * Bc, (i + 1) * Bc)
        with torch.enable_grad():
            prim = [t.detach().requires_grad_()
                    for t in (q[rows], k[rows], v[rows], wr, u, vb)]
            out = flash_mhsa_rel_plain(*prim, lengths[rows], out_f32)
            parts.append(torch.autograd.grad(out, prim, g[rows]))
    if nchunks == 1:
        return parts[0]
    dq, dk, dv = (torch.cat([p[j] for p in parts]) for j in range(3))
    dw = (torch.stack([p[j].float() for p in parts]).sum(0).to(t.dtype)
          for j, t in zip(range(3, 6), (wr, u, vb)))
    return (dq, dk, dv, *dw)


class _FlashMHSARel(torch.autograd.Function):
    """The JAX package's `_flash_core` custom_vjp: the kernel forward, the
    recompute backward (`flash_mhsa_rel_vjp`) from the saved primals."""

    @staticmethod
    def forward(ctx, q, k, v, wr, u, vb, lengths, out_f32):
        ctx.save_for_backward(q, k, v, wr, u, vb, lengths)
        ctx.out_f32 = out_f32
        return _flash_forward(q, k, v, wr, u, vb, lengths, out_f32)

    @staticmethod
    def backward(ctx, g):
        grads = flash_mhsa_rel_vjp(*ctx.saved_tensors, g, ctx.out_f32)
        return (*grads, None, None)


def flash_mhsa_rel(q, k, v, wr, u, vb, lengths,
                   out_f32: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, T, dh] (any float dtype, any strides; bf16 inside),
    wr: [D, D] (D = H * dh), u, vb: [H, dh], lengths: [B] valid key counts.
    Returns [B, H, T, dh], float32 when out_f32 else bf16; from the kernel
    it is a view of a [T, B, H, dh] tensor, so that the time-major
    [T, B, D] caller reshapes it without a copy. Differentiable in q, k,
    v, wr, u and vb (`flash_mhsa_rel_vjp`)."""
    return _FlashMHSARel.apply(q, k, v, wr, u, vb, lengths, out_f32)
