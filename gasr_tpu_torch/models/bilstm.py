"""BiLSTM-CTC acoustic model (the `bilstm_2x256` preset).

Features -> N-layer (bi)LSTM -> linear projection to vocab+blank ->
log_softmax. The same I/O contract as the DeepSpeech model:
x [B, T, feat] -> log-probs [T, B, vocab+1]. Param names and layouts
are the JAX package's (`gasr_tpu/models/bilstm.py`).
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.ops.linear import linear, linear_init
from gasr_tpu_torch.ops.lstm import lstm_forward, lstm_init


def bilstm_init(generator: torch.Generator, config: Config,
                device="cpu", dtype=torch.float32) -> dict:
    H = config.rnn_hidden_size
    n_dir = 2 if config.bidirectional else 1
    return {
        "lstm": lstm_init(generator, config.feat_size, H,
                          config.rnn_num_layers, config.bidirectional,
                          device, dtype),
        "proj": linear_init(generator, H * n_dir, config.output_size,
                            device, dtype),
    }


def bilstm_apply(params: dict, x: torch.Tensor, rnn_impl: str = "scan",
                 **_) -> torch.Tensor:
    """x: [B, T, feat] -> log-probs [T, B, vocab+1]. Other keywords are
    taken and ignored, as in the JAX package."""
    h = lstm_forward(params["lstm"], x.transpose(0, 1), impl=rnn_impl)
    logits = linear(params["proj"], h, None)
    return torch.log_softmax(logits, dim=-1)
