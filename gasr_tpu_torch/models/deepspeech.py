"""DeepSpeech-1 CTC acoustic model (the flagship topology).

  3 x (Linear + ReLU) -> RNN (tanh, unidirectional) -> Linear + ReLU
  -> Linear (no act) -> log_softmax over vocab+blank.

Functions over a param dict with the JAX package's names and layouts,
so `runtime.checkpoint.params_from_jax` carries weights across as they
are. `compat_final_relu=True` reproduces the reference CUDA path's
final ReLU, whose output goes to the decoder unnormalised.

I/O: x [B, T, feat] -> log-probs [T, B, vocab+1], time-major.
"""

from __future__ import annotations

from typing import Optional

import torch

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.ops.linear import linear, linear_init
from gasr_tpu_torch.ops.rnn import rnn_forward, rnn_init


def deepspeech_init(generator: torch.Generator, config: Config,
                    device="cpu") -> dict:
    feat = config.feat_size
    L = config.linear_size
    H = config.rnn_hidden_size
    return {
        "mlp1": linear_init(generator, feat, L, device),
        "mlp2": linear_init(generator, L, L, device),
        "mlp3": linear_init(generator, L, H, device),
        "rnn": rnn_init(generator, H, H, config.rnn_num_layers,
                        config.bidirectional, device),
        "mlp5": linear_init(generator, H, L, device),
        "mlp6": linear_init(generator, L, config.output_size, device),
    }


def deepspeech_apply(params: dict, x: torch.Tensor, *,
                     compat_final_relu: bool = False,
                     rnn_impl: str = "scan",
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """x: [B, T, feat] -> log-probs [T, B, vocab+1]."""
    x = x.transpose(0, 1)                    # time-major [T, B, F]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    h = linear(params["mlp1"], x, "relu", compute_dtype)
    h = linear(params["mlp2"], h, "relu", compute_dtype)
    h = linear(params["mlp3"], h, "relu", compute_dtype)
    h = rnn_forward(params["rnn"], h, impl=rnn_impl)
    h = linear(params["mlp5"], h, "relu", compute_dtype)
    logits = linear(params["mlp6"], h, None, compute_dtype)
    if compat_final_relu:
        return torch.relu(logits)
    return torch.log_softmax(logits, dim=-1)
