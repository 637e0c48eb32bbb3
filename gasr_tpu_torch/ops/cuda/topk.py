"""Exact, stable row-wise top-k — `lax.top_k`'s order, bit for bit.

Replaces the selection machinery of `gasr_tpu/ops/pallas/topk.py`
(`pallas_topk` / `_topk_kernel`, with `_monotone_bits` and
`_bitonic_sort_desc`). The order is score descending, then index
ascending, on a total order of the float bits: `monotone_bits` maps
float32 to uint32 so that unsigned order is float order with
-0.0 < +0.0. Neither `torch.topk` (no tie order) nor a stable
`torch.sort` of the floats (+0.0 and -0.0 compare equal) gives it.

The CUDA side (`csrc/topk.cuh`) is one block-level selection on one
64-bit key per candidate, exact and threshold-filtered (`select_seed`,
`select_walk`, `select_rank`; k <= 128): the decode kernels run it each
frame, and `csrc/topk.cu` wraps it as the standalone `topk` kernel, one
block a row, which the chip check holds against `topk_plain`.
`topk` launches that kernel for CUDA tensors and runs `topk_plain` for
CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gasr_tpu_torch.ops.cuda import _lib

# launches of the standalone `topk` kernel; the fused decode kernel runs
# the same device function inside its own launch and is not counted here
launches = 0

MAX_K = 128              # a warp's list holds 128 keys
_IDX_BITS = 31


def monotone_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 with the same total order, held in int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def topk_plain(x: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: sort one int64 key per element,
    (monotone bits << 31) | (2^31 - 1 - index), descending. Keys are
    unique, so the sort needs no stability."""
    n = x.shape[-1]
    if n >= 2 ** _IDX_BITS:
        raise ValueError("topk_plain: row too long for the index field")
    idx_max = (1 << _IDX_BITS) - 1
    iota = torch.arange(n, device=x.device, dtype=torch.int64)
    keys = (monotone_bits(x) << _IDX_BITS) | (idx_max - iota)
    top = torch.sort(keys, dim=-1, descending=True).values[..., :k]
    idx = idx_max - (top & idx_max)
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, N] float32 -> (values [B, k] float32, indices [B, k] int32)."""
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {x.device}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("topk: x must be float32 [B, N]")
    B, N = x.shape
    if not 1 <= k <= min(N, MAX_K) or N >= 2 ** 31:
        raise ValueError(f"topk: needs 1 <= k <= min(N, {MAX_K}), got "
                         f"k={k}, N={N}")
    x = x.contiguous()
    vals = torch.empty(B, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(B, k, dtype=torch.int32, device=x.device)
    if B == 0:
        return vals, idx
    lib = _lib.load("topk")
    err = lib.topk_launch(_lib.ptr(x), B, N, k, _lib.ptr(vals),
                          _lib.ptr(idx), _lib.stream(x.device))
    _lib.check(err, "topk")
    global launches
    launches += 1
    return vals, idx
