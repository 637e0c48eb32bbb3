"""The card's published peaks and the least time a kernel's algorithm
needs at its shapes: the larger of operations / peak rate and bytes /
memory bandwidth (`least_s`). Bytes count each input read once and each
output written once. A frozen copy of `chip_smoke.py`'s `bound(...)`
counts for the three kernels the cells report.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12            # float32 / int32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_s(nbytes: float, ops: float, peak_ops: float
            ) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): whichever bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rnn_scan(T: int, B: int, H: int) -> Tuple[float, str]:
    """The Elman recurrence: xw [T, B, H] float32 read, out written,
    W_hh in bf16, h0; 2 T B H^2 on the bf16 tensor cores."""
    return least_s(2 * T * B * H * 4 + H * H * 2 + B * H * 4,
                   2 * T * B * H * H, BF16_TENSOR_FLOPS)


def fused_prefix_decode(T: int, B: int, V: int, W: int) -> Tuple[float, str]:
    """All T frames of the prefix beam search: log-probs read once, the
    9-field beam state read and written, backpointers [T, B, W] written;
    2 W V + 30 W operations a frame and utterance outside the tensor
    cores."""
    return least_s(T * B * V * 4 + 2 * 9 * B * W * 4 + T * B * W * 4,
                   T * B * (2 * W * V + 30 * W), F32_FLOPS)


def flash_mhsa_rel(B: int, H: int, T: int, dh: int) -> Tuple[float, str]:
    """One relative-position attention call: q.k, (q+v).R at every (t, s)
    and p.v, and the R product; q, k, v and the output at bf16, W_r at
    float32, u and v float32."""
    D = H * dh
    flops = 2 * B * H * 3 * T * T * dh + 2 * (2 * T - 1) * D * D
    nbytes = 4 * (B * H * T * dh) * 2 + D * D * 4 + 2 * H * dh * 4
    return least_s(nbytes, flops, BF16_TENSOR_FLOPS)
