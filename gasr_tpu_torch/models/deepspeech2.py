"""DeepSpeech2-style Conv + BiLSTM CTC model (the `deepspeech2` preset).

Spectrogram [B, T, F] -> two clipped-ReLU conv2d over (time, freq),
11x41 stride 2x2 then 11x21 stride 1x2, 32 channels, "SAME" padding ->
flatten to (freq'', channel) -> (bi)LSTM stack -> projection ->
log_softmax. Output [T', B, vocab+1] with T' = ceil(T / 2)
(`ds2_output_length`). Param names and layouts (HWIO conv weights) are
the JAX package's (`gasr_tpu/models/deepspeech2.py`).
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.ops.conv import conv2d, conv2d_init
from gasr_tpu_torch.ops.linear import linear, linear_init
from gasr_tpu_torch.ops.lstm import lstm_forward, lstm_init

_CONV1_KERNEL = (11, 41)
_CONV1_STRIDE = (2, 2)
_CONV2_KERNEL = (11, 21)
_CONV2_STRIDE = (1, 2)
_CHANNELS = 32


def ds2_output_length(input_length):
    """Frames out for frames in ("SAME" padding, stride 2 then 1)."""
    return -(-input_length // _CONV1_STRIDE[0])


def ds2_init(generator: torch.Generator, config: Config,
             device="cpu", dtype=torch.float32) -> dict:
    f1 = -(-config.feat_size // _CONV1_STRIDE[1])
    f2 = -(-f1 // _CONV2_STRIDE[1])
    H = config.rnn_hidden_size
    n_dir = 2 if config.bidirectional else 1
    return {
        "conv1": conv2d_init(generator, 1, _CHANNELS, _CONV1_KERNEL, device,
                             dtype),
        "conv2": conv2d_init(generator, _CHANNELS, _CHANNELS, _CONV2_KERNEL,
                             device, dtype),
        "lstm": lstm_init(generator, f2 * _CHANNELS, H,
                          config.rnn_num_layers, config.bidirectional,
                          device, dtype),
        "proj": linear_init(generator, H * n_dir, config.output_size,
                            device, dtype),
    }


def ds2_apply(params: dict, x: torch.Tensor, rnn_impl: str = "scan",
              **_) -> torch.Tensor:
    """x: [B, T, F] -> log-probs [T', B, vocab+1]. Other keywords are
    taken and ignored, as in the JAX package."""
    B = x.shape[0]
    h = conv2d(params["conv1"], x[..., None], _CONV1_STRIDE)   # NHWC
    h = conv2d(params["conv2"], h, _CONV2_STRIDE)         # [B, T', F'', C]
    _, Tp, Fp, C = h.shape
    h = h.reshape(B, Tp, Fp * C).transpose(0, 1)          # [T', B, F''*C]
    h = lstm_forward(params["lstm"], h, impl=rnn_impl)
    logits = linear(params["proj"], h, None)
    return torch.log_softmax(logits, dim=-1)
