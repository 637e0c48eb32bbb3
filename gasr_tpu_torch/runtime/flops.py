"""Analytic forward and training FLOP counts per model family and the
card's peak, for MFU (the port's copy of `gasr_tpu/runtime/flops.py`).

2 x MACs for every GEMM, convolution and recurrence; cheap elementwise
work is not counted. The counts follow the compute graphs of `models/`,
which are the JAX package's: every preset gets the same count as there.

MFU is stated against the card's dense bf16 tensor-core peak, for the
float32 presets too (as the JAX package states it against its chip's
bf16 peak): a float32 model's MFU reads low by the ratio of the two
rates.
"""

from __future__ import annotations

from typing import Optional

from gasr_tpu_torch.config import Config

# dense bf16 tensor-core peak FLOP/s of the Hopper cards the kernels are
# built for (sm_90a), by CUDA device name substring (NVIDIA data sheets,
# without sparsity); the H100 SXM's is PERF.md's
_PEAKS = {
    "h100 80gb hbm3": 989e12,     # H100 SXM
    "h100 sxm": 989e12,
    "h100 nvl": 835e12,
    "h100 pcie": 756e12,
    "h200": 989e12,
}


def device_peak_flops(device=None) -> Optional[float]:
    """The dense bf16 peak of a CUDA device (default: the current one),
    matched on `torch.cuda.get_device_name`; None for the CPU or a card
    the table does not name."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for sub, peak in _PEAKS.items():
        if sub in name:
            return peak
    return None


def _linear_flops(tokens: int, d_in: int, d_out: int) -> float:
    return 2.0 * tokens * d_in * d_out


def _lstm_flops(tokens: int, layers_io) -> float:
    """layers_io: list of (d_in, H, n_dir). Cell = input GEMM + recurrent
    GEMM into 4 gates."""
    total = 0.0
    for d_in, H, n_dir in layers_io:
        total += n_dir * (2.0 * tokens * d_in * 4 * H
                          + 2.0 * tokens * H * 4 * H)
    return total


def _conv2d_flops(out_elems: int, kh: int, kw: int, cin: int,
                  cout: int) -> float:
    return 2.0 * out_elems * kh * kw * cin * cout


def model_fwd_flops(cfg: Config) -> float:
    """Analytic forward FLOPs for one batch at the config's shape."""
    B, T, F = cfg.batch_size, cfg.seg_len, cfg.feat_size
    L, H, O = cfg.linear_size, cfg.rnn_hidden_size, cfg.output_size
    n_dir = 2 if cfg.bidirectional else 1
    tok = B * T

    if cfg.model == "deepspeech":
        # models/deepspeech.py: 3xMLP -> RNN -> MLP -> proj
        f = (_linear_flops(tok, F, L) + _linear_flops(tok, L, L)
             + _linear_flops(tok, L, H))
        # the RNN cell: input GEMM + recurrent GEMM per direction and layer
        f += cfg.rnn_num_layers * n_dir * (
            2.0 * tok * H * H + 2.0 * tok * H * H)
        f += _linear_flops(tok, H * n_dir, L) + _linear_flops(tok, L, O)
        return f

    if cfg.model == "bilstm":
        ios = [(F, H, n_dir)]
        for _ in range(cfg.rnn_num_layers - 1):
            ios.append((H * n_dir, H, n_dir))
        return _lstm_flops(tok, ios) + _linear_flops(tok, H * n_dir, O)

    if cfg.model == "deepspeech2":
        from gasr_tpu_torch.models.deepspeech2 import (
            _CHANNELS, _CONV1_KERNEL, _CONV1_STRIDE, _CONV2_KERNEL,
            _CONV2_STRIDE)
        t1 = -(-T // _CONV1_STRIDE[0])
        f1 = -(-F // _CONV1_STRIDE[1])
        t2 = -(-t1 // _CONV2_STRIDE[0])
        f2 = -(-f1 // _CONV2_STRIDE[1])
        f = _conv2d_flops(B * t1 * f1, *_CONV1_KERNEL, 1, _CHANNELS)
        f += _conv2d_flops(B * t2 * f2, *_CONV2_KERNEL, _CHANNELS,
                           _CHANNELS)
        tok2 = B * t2
        ios = [(f2 * _CHANNELS, H, n_dir)]
        for _ in range(cfg.rnn_num_layers - 1):
            ios.append((H * n_dir, H, n_dir))
        return (f + _lstm_flops(tok2, ios)
                + _linear_flops(tok2, H * n_dir, O))

    if cfg.model in ("conformer_s", "conformer_l", "conformer"):
        from gasr_tpu_torch.models.conformer import _preset
        hp = _preset(cfg)
        d = hp["d_model"]
        mult, K = hp["ff_mult"], hp["conv_kernel"]
        t1, f1 = -(-T // 2), -(-F // 2)
        t2, f2 = -(-t1 // 2), -(-f1 // 2)
        f = _conv2d_flops(B * t1 * f1, 3, 3, 1, d)
        f += _conv2d_flops(B * t2 * f2, 3, 3, d, d)
        tok2 = B * t2
        f += _linear_flops(tok2, d * f2, d)            # sub_proj
        per_block = (
            2 * (_linear_flops(tok2, d, d * mult) * 2)  # two half-FFNs
            + 4 * _linear_flops(tok2, d, d)             # q k v o
            + _linear_flops(2 * t2 - 1, d, d)           # rel-pos proj
            + 2.0 * tok2 * t2 * d                       # ac scores
            + 2.0 * tok2 * (2 * t2 - 1) * d             # bd scores
            + 2.0 * tok2 * t2 * d                       # attn @ V
            + _linear_flops(tok2, d, 2 * d)             # conv pw1
            + 2.0 * tok2 * K * d                        # depthwise
            + _linear_flops(tok2, d, d)                 # conv pw2
        )
        f += hp["num_blocks"] * per_block
        f += _linear_flops(tok2, d, O)
        return f

    raise ValueError(f"unknown model {cfg.model!r}")


def model_train_flops(cfg: Config) -> float:
    """Analytic FLOPs for one training step = 3x forward (the backward
    costs about two forwards: dL/dW and dL/dx are each a forward-sized
    GEMM set). The CTC loss and the optimizer count as zero, which
    slightly understates train MFU."""
    return 3.0 * model_fwd_flops(cfg)
