"""Elman recurrence kernel: out[t] = tanh(xw[t] + bf16(h_{t-1}) @ bf16(W_hh)).

Replaces `gasr_tpu/ops/pallas/rnn_scan.py::rnn_scan_pallas_raw`
(kernel body `_kernel`): h is rounded to bf16 before the product, W_hh
is held in bf16, the product accumulates in float32, and the float32
sum with xw goes through tanh. Forward or reverse in time; the output
keeps xw's time index.

`rnn_scan` launches the CUDA kernel (`csrc/rnn_scan.cu`: one persistent
cooperative launch a call, W_hh resident in shared memory, K split over
clusters of 8 blocks, a step barrier between steps) for CUDA tensors and
runs `rnn_scan_plain` for CPU tensors. Every B goes through the kernel;
H up to the resident limit (`max_hidden`: W_hh's slices, the staged
chunk of h and the partial sums must fit in the blocks' shared memory),
past which it raises `ValueError`. Other weight dtypes or devices raise.
`ops/rnn.py::rnn_forward` takes it only where `_lib.scan_supported`
(the JAX package's shape rule) holds.
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by rnn_scan (one per call)
launches = 0

# the kernel's decomposition (csrc/rnn_scan.cu)
CLUSTER = 8           # blocks of a cluster: W_hh's K rows split 8 ways
UNIT_ALIGN = 8        # a cluster's units: a multiple of the n8 tile
NU_MAX = 192          # units a cluster at most
MAX_CLUSTERS = 32     # the most clusters a call is split into
CHUNK_ROWS = (128, 64)   # batch rows a chunk, the larger where it fits
SMEM_MAX = 232448     # a block's shared memory on sm_90


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(H: int, smem, max_clusters):
    """The kernel's decomposition at hidden width H: (Hp, NU, G, MB), H
    padded to a multiple of 128 (so each of the 8 K slices is a multiple
    of 16), G clusters of NU units each (the last may hold fewer), batch
    chunks of MB = 128 rows (64 where 128 do not fit), or None past the
    resident limit. `smem(NU, Kb, MB)` gives a block's shared memory,
    `max_clusters(NU, MB, bytes)` how many clusters of that build the card
    holds at once; the most clusters that fit win."""
    Hp = _round_up(H, 128)
    Kb = Hp // CLUSTER
    for G in range(min(Hp // UNIT_ALIGN, MAX_CLUSTERS), 0, -1):
        NU = _round_up(-(-Hp // G), UNIT_ALIGN)
        need = {MB: smem(NU, Kb, MB) for MB in CHUNK_ROWS}
        if NU > NU_MAX or min(need.values()) > SMEM_MAX:
            return None          # fewer clusters would need more
        Gu = -(-Hp // NU)
        for MB, nbytes in need.items():
            if nbytes <= SMEM_MAX and Gu <= max_clusters(NU, MB, nbytes):
                return Hp, NU, Gu, MB
    return None


_plans: dict = {}


def _card_plan(device, H: int):
    key = (device.index, H)
    if key not in _plans:
        lib = _lib.load("rnn_scan")
        _plans[key] = plan(H, lib.rnn_scan_smem, lib.rnn_scan_max_clusters)
    return _plans[key]


def max_hidden(device) -> int:
    """The largest H the kernel takes on this card (a multiple of 128)."""
    H = 128
    while _card_plan(device, H + 128) is not None:
        H += 128
    return H if _card_plan(device, H) is not None else 0


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
    p = _card_plan(xw.device, H)
    if p is None:
        raise ValueError(
            f"rnn_scan: H={H} is past the kernel's resident limit H <= "
            f"{max_hidden(xw.device)} on this card (W_hh stays in the blocks' "
            f"shared memory: H^2 x 2 bytes over the co-resident clusters, "
            f"beside the ring and the partial sums)")
    Hp, NU, G, MB = p
    # the kernel reads float32 W_hh and rounds it to bf16 itself, and takes
    # any H: units and K rows past H read as zeros
    w = w_hh if w_hh.dtype == torch.float32 else w_hh.float()
    xw, w, h = xw.contiguous(), w.contiguous(), h0.float().contiguous()
    out = torch.empty_like(xw)
    hbf = torch.empty(2, B, Hp, dtype=torch.bfloat16, device=xw.device)
    vec = int(H % 4 == 0 and xw.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    bar = torch.empty(G * CLUSTER, dtype=torch.int64, device=xw.device)
    lib = _lib.load("rnn_scan")
    err = lib.rnn_scan_launch(
        _lib.ptr(xw), _lib.ptr(w), _lib.ptr(h), T, B, H, Hp, NU, G, MB,
        int(reverse), vec, _lib.ptr(out), _lib.ptr(hbf), _lib.ptr(bar),
        None, _lib.stream(xw.device))
    _lib.check(err, "rnn_scan")
    global launches
    launches += 1
    return out
