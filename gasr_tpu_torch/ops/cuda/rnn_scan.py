"""Elman recurrence kernel: out[t] = tanh(xw[t] + bf16(h_{t-1}) @ bf16(W_hh)).

Replaces `gasr_tpu/ops/pallas/rnn_scan.py::rnn_scan_pallas_raw`
(kernel body `_kernel`): h is rounded to bf16 before the product, W_hh
is held in bf16, the product accumulates in float32, and the float32
sum with xw goes through tanh. Forward or reverse in time; the output
keeps xw's time index.

`rnn_scan` launches the CUDA kernel (`csrc/rnn_scan.cu`, one fused
tensor-core GEMM + tanh launch per step) for CUDA tensors and runs
`rnn_scan_plain` for CPU tensors. Every (B, H) goes through the kernel;
other weight dtypes or devices raise. `ops/rnn.py::rnn_forward` takes
it only where `_lib.scan_supported` (the JAX package's shape rule) holds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by rnn_scan (one per time step)
launches = 0


def rnn_scan_plain(xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
                   reverse: bool = False,
                   weight_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Plain PyTorch version: the same casts, step by step.

    Products of two bf16 values are exact in float32, so the float32
    matmul of the up-cast operands is the bf16 product with float32
    accumulation."""
    w = w_hh.to(weight_dtype).float()
    out = torch.empty_like(xw)
    h = h0.float()
    steps = range(xw.shape[0] - 1, -1, -1) if reverse else range(xw.shape[0])
    for t in steps:
        h = torch.tanh(xw[t] + torch.matmul(h.to(weight_dtype).float(), w))
        out[t] = h
    return out


def rnn_scan(xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
             reverse: bool = False,
             weight_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xw: [T, B, H] float32 input projection (+ biases); w_hh: [H, H];
    h0: [B, H]. Returns the hidden history [T, B, H] float32."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xw, w_hh, h0)):
        raise NotImplementedError(
            "rnn_scan is forward only, as JAX's rnn_scan_pallas_raw (the "
            "backward comes with training, ROADMAP.md Queue 1 item 12)")
    if xw.device.type == "cpu":
        return rnn_scan_plain(xw, w_hh, h0, reverse, weight_dtype)
    if xw.device.type != "cuda":
        raise ValueError(f"rnn_scan: unsupported device {xw.device}")
    if weight_dtype != torch.bfloat16:
        raise ValueError("rnn_scan: the CUDA kernel holds W_hh in bf16 only")
    if xw.ndim != 3 or xw.dtype != torch.float32:
        raise ValueError("rnn_scan: xw must be float32 [T, B, H]")
    T, B, H = xw.shape
    if tuple(w_hh.shape) != (H, H) or tuple(h0.shape) != (B, H):
        raise ValueError(f"rnn_scan: w_hh {tuple(w_hh.shape)} / h0 "
                         f"{tuple(h0.shape)} do not fit xw {tuple(xw.shape)}")
    for t in (w_hh, h0):
        if t.device != xw.device:
            raise ValueError("rnn_scan: all tensors must be on one device")
    if T * B * H == 0:
        return torch.empty_like(xw)
    # The kernel reads 16-byte rows, so H goes up to a multiple of 8 with
    # zeros: zero W_hh rows and columns and zero xw keep the padded units
    # at tanh(0) = 0 and out of every real unit's sum.
    pad = -H % 8
    w = w_hh.to(torch.bfloat16)
    h = h0.to(torch.float32)
    if pad:
        xw = F.pad(xw, (0, pad))
        w = F.pad(w, (0, pad, 0, pad))
        h = F.pad(h, (0, pad))
    xw, w, h = xw.contiguous(), w.contiguous(), h.contiguous()
    out = torch.empty_like(xw)
    lib = _lib.load("rnn_scan")
    err = lib.rnn_scan_launch(_lib.ptr(xw), _lib.ptr(w), _lib.ptr(h),
                              T, B, H + pad, int(reverse), _lib.ptr(out),
                              _lib.stream(xw.device))
    _lib.check(err, "rnn_scan")
    global launches
    launches += T
    return out[..., :H] if pad else out
