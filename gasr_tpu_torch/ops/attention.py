"""Multi-head self-attention: with Transformer-XL relative positions
(`mhsa_rel`, the Conformer models', the port of
`gasr_tpu/ops/attention.py`) and without any position term (`mhsa`,
wav2vec 2.0's, whose position comes from a convolution before the
layers; the port's own).

Time-major [T, B, D] like the rest of the stack. Two routes compute it:
  - the rel-shift route (the JAX package's "xla" path): position scores
    against the sinusoid embeddings of every offset T-1 .. -(T-1), moved
    into place by the pad-and-reshape Transformer-XL shift;
  - the fused kernel (`ops/cuda/flash_mhsa.py`, the JAX package's
    "pallas" path), which reads the same position scores from a band of
    the projected embeddings in shared memory and keeps every O(T^2)
    tensor out of device memory. It takes q, k and v as strided views of
    the qkv product and returns a view that reshapes to [T, B, D] without
    a copy.
Projection biases ("bq", "bk", "bv", "bo" [D] in `params`, where the
model has them; the JAX package's have none) are added to the qkv and
output products in float32, at the compute dtype's resolution, on both
routes; the qkv product's bias add and rounding are `bias_act`'s
`epilogue` (one kernel launch on a bf16 CUDA forward outside autograd).
`impl` keeps the JAX package's names ("xla" | "pallas" | "auto") so
configs carry across; `use_flash_kernel` is JAX's dispatch rule with "on
the accelerator" read as "on a CUDA tensor".

`mhsa` computes softmax((q . k) / sqrt(dh)) . v with biased q, k, v and
output products, on the eager route or, where `use_flash_kernel` holds
and autograd does not record, through the position-free kernel
(`ops/cuda/flash_mhsa.py::flash_mhsa`, one launch a call).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.cuda.bias_act import epilogue
from gasr_tpu_torch.ops.cuda.flash_mhsa import (flash_eligible, flash_mhsa,
                                                flash_mhsa_rel)
from gasr_tpu_torch.ops.linear import linear_init, matmul, normal_init


def _sinusoid_pos(n: int, d: int, device="cpu") -> torch.Tensor:
    """Sinusoidal embeddings for relative positions [n-1 .. -(n-1)]:
    [2n-1, d], sin block then cos block."""
    pos = torch.arange(n - 1, -n, -1, dtype=torch.float32, device=device)
    inv = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (math.log(10000.0) / d))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mhsa_rel_init(generator: torch.Generator, d_model: int, num_heads: int,
                  device="cpu", dtype=torch.float32) -> dict:
    """N(0, 1/d) projections wq, wk, wv, wo, wr [D, D]; zero biases u, v
    [H, dh] (the JAX package's names and layouts)."""
    dh = d_model // num_heads
    s = 1.0 / (d_model ** 0.5)
    p = {name: normal_init(generator, (d_model, d_model), s, device, dtype)
         for name in ("wq", "wk", "wv", "wo", "wr")}
    p["u"] = torch.zeros((num_heads, dh), device=device, dtype=dtype)
    p["v"] = torch.zeros((num_heads, dh), device=device, dtype=dtype)
    return p


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] (cols = rel offsets T-1 .. -(T-1)) -> [B, H, T, T]
    with out[..., i, j] = x[..., i, (T-1) - (i - j)], by pad and reshape."""
    B, H, T, L = x.shape
    x = F.pad(x, (0, 1))                                 # [B, H, T, 2T]
    x = x.reshape(B, H, 2 * T * T)
    x = F.pad(x, (0, T - 1))
    x = x.reshape(B, H, T + 1, 2 * T - 1)
    return x[:, :, :T, T - 1:]


def _out_proj(params: dict, out: torch.Tensor, cd) -> torch.Tensor:
    """The heads' concatenation through W_o (and its bias, where the model
    has one), float32."""
    y = matmul(out, params["wo"] if cd is None else params["wo"].to(cd), cd)
    if "bo" in params:
        y = y + (params["bo"] if cd is None else params["bo"].to(cd)).float()
    return y


def use_flash_kernel(impl: str, T: int, dh: int, D: int, has_mask: bool,
                     compute_dtype: Optional[torch.dtype],
                     on_cuda: bool) -> bool:
    """The JAX package's rule (`attention.py::mhsa_rel`): "pallas" takes
    the kernel whenever the shape is eligible and there is no boolean
    mask; "auto" also needs bf16 compute and the accelerator (here a CUDA
    tensor); anything else takes the rel-shift route."""
    if impl not in ("xla", "pallas", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "xla":
        return False
    ok = flash_eligible(T, dh, D) and not has_mask
    if impl == "pallas":
        return ok
    return ok and compute_dtype == torch.bfloat16 and on_cuda


def mhsa_rel(params: dict, x: torch.Tensor, num_heads: int,
             mask: Optional[torch.Tensor] = None,
             compute_dtype: Optional[torch.dtype] = None,
             impl: str = "auto",
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [T, B, D] -> float32 [T, B, D]. mask: [B, T] True for valid
    frames; lengths: [B] valid prefix lengths (the kernel's mask form).

    compute_dtype (bf16): every product takes operands at that type with
    float32 sums; the softmax stays float32; the position scores are
    shifted at the reduced type. With impl="pallas" the kernel computes
    at bf16 whatever compute_dtype is; compute_dtype=None then only
    restores a float32 output, as in the JAX package.
    """
    T, B, D = x.shape
    dh = D // num_heads
    cd = compute_dtype
    c = (lambda a: a.to(cd)) if cd is not None else (lambda a: a)
    use_kernel = use_flash_kernel(impl, T, dh, D, mask is not None, cd,
                                  x.device.type == "cuda")

    # q, k, v in one [D, 3D] product: its column blocks are the three
    # separate products
    wqkv = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
    qkv = matmul(c(x), wqkv, cd)
    if "bq" in params:
        qkv = epilogue(qkv, torch.cat([params["bq"], params["bk"],
                                       params["bv"]]), "none", cd)
    else:
        qkv = c(qkv)
    q = qkv[:, :, :D].reshape(T, B, num_heads, dh)
    k = qkv[:, :, D:2 * D].reshape(T, B, num_heads, dh)
    v = qkv[:, :, 2 * D:].reshape(T, B, num_heads, dh)

    if use_kernel:
        lens = (torch.full((B,), T, dtype=torch.int32, device=x.device)
                if lengths is None else lengths.to(torch.int32))
        tb = lambda a: a.permute(1, 2, 0, 3)            # noqa: E731
        out = flash_mhsa_rel(tb(q), tb(k), tb(v), params["wr"], params["u"],
                             params["v"], lens, out_f32=cd is None)
        out = c(out.permute(2, 0, 1, 3)).reshape(T, B, D)
        return _out_proj(params, out, cd)

    if lengths is not None and mask is None:
        # prefix lengths are the kernel's mask form; honour them here too
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths.to(x.device)[:, None])

    r = torch.matmul(_sinusoid_pos(T, D, x.device), params["wr"])  # [2T-1, D]
    r = c(r).reshape(2 * T - 1, num_heads, dh)

    # content and position terms (Transformer-XL, with biases u and v)
    qu = (q + c(params["u"])[None, None]).permute(1, 2, 0, 3)   # [B,H,T,dh]
    qv = (q + c(params["v"])[None, None]).permute(1, 2, 0, 3)
    kt = k.permute(1, 2, 3, 0)                                  # [B,H,dh,S]
    ac = matmul(qu, kt, cd)                                     # [B,H,T,S]
    rt = r.permute(1, 2, 0)[None].expand(B, -1, -1, -1)         # [B,H,dh,L]
    bd = _rel_shift(c(matmul(qv, rt, cd)))                      # [B,H,T,T]

    scores = (ac + bd.float()) / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores,
                             torch.tensor(-1e30, device=x.device))
    attn = c(torch.softmax(scores, dim=-1))
    out = matmul(attn, v.permute(1, 2, 0, 3), cd)               # [B,H,T,dh]
    out = c(out.permute(2, 0, 1, 3)).reshape(T, B, D)
    return _out_proj(params, out, cd)


def mhsa_init(generator: torch.Generator, d_model: int, device="cpu"
              ) -> dict:
    """U(-1/sqrt(d), 1/sqrt(d)) projections wq, wk, wv, wo [D, D] and
    biases bq, bk, bv, bo [D] (torch.nn.Linear's scale)."""
    p = {}
    for n in ("q", "k", "v", "o"):
        lin = linear_init(generator, d_model, d_model, device)
        p["w" + n], p["b" + n] = lin["w"], lin["b"]
    return p


def mhsa(params: dict, x: torch.Tensor, num_heads: int,
         compute_dtype: Optional[torch.dtype] = None, impl: str = "auto"
         ) -> torch.Tensor:
    """Position-free attention over all T keys. x: [T, B, D] -> float32
    [T, B, D].

    compute_dtype (bf16): every product takes operands at that type with
    float32 sums; the qkv product's bias add and rounding are
    `bias_act`'s epilogue; the softmax stays float32, its output rounded
    to bf16 before the product with v (the kernel rounds the unnormalized
    probabilities instead: `ops/cuda/flash_mhsa.py`)."""
    T, B, D = x.shape
    dh = D // num_heads
    cd = compute_dtype
    c = (lambda a: a.to(cd)) if cd is not None else (lambda a: a)
    wqkv = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
    records = torch.is_grad_enabled() and (
        x.requires_grad or any(params[n].requires_grad for n in
                               ("wq", "wk", "wv", "bq", "bk", "bv")))
    use_kernel = not records and use_flash_kernel(
        impl, T, dh, D, False, cd, x.device.type == "cuda")
    qkv = epilogue(matmul(c(x), wqkv, cd),
                   torch.cat([params["bq"], params["bk"], params["bv"]]),
                   "none", cd)
    tb = lambda a: a.reshape(T, B, num_heads, dh).permute(1, 2, 0, 3)  # noqa
    q, k, v = tb(qkv[:, :, :D]), tb(qkv[:, :, D:2 * D]), tb(qkv[:, :, 2 * D:])
    if use_kernel:
        lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
        out = flash_mhsa(q, k, v, lens, out_f32=cd is None)
        return _out_proj(params, c(out.permute(2, 0, 1, 3)).reshape(T, B, D),
                         cd)
    scores = matmul(q, k.transpose(-1, -2), cd) / math.sqrt(dh)  # [B,H,T,S]
    attn = c(torch.softmax(scores, dim=-1))
    out = matmul(attn, v, cd)                                   # [B,H,T,dh]
    out = c(out.permute(2, 0, 1, 3)).reshape(T, B, D)
    return _out_proj(params, out, cd)
