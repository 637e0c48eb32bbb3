"""DeepSpeech-1 CTC acoustic model (the flagship topology).

  3 x (Linear + ReLU) -> RNN (tanh, unidirectional unless the config
  asks for bidirectional) -> Linear + ReLU -> Linear (no act)
  -> log_softmax over vocab+blank.

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
from gasr_tpu_torch.ops.linear import linear, linear_init, matmul
from gasr_tpu_torch.ops.rnn import (rnn_forward, rnn_forward_streaming,
                                    rnn_forward_tp, rnn_init)
from gasr_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                 copy_to_group)
from gasr_tpu_torch.runtime.profiler import span


def deepspeech_init(generator: torch.Generator, config: Config,
                    device="cpu", dtype=torch.float32) -> dict:
    feat = config.feat_size
    L = config.linear_size
    H = config.rnn_hidden_size
    n_dir = 2 if config.bidirectional else 1
    return {
        "mlp1": linear_init(generator, feat, L, device, dtype),
        "mlp2": linear_init(generator, L, L, device, dtype),
        "mlp3": linear_init(generator, L, H, device, dtype),
        "rnn": rnn_init(generator, H, H, config.rnn_num_layers,
                        config.bidirectional, device, dtype),
        "mlp5": linear_init(generator, H * n_dir, L, device, dtype),
        "mlp6": linear_init(generator, L, config.output_size, device, dtype),
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


def deepspeech_apply_tp(params: dict, x: torch.Tensor,
                        group) -> torch.Tensor:
    """`deepspeech_apply` (float32, rnn_impl="scan") on a tensor-parallel
    group: `params` holds this rank's shards per
    `parallel/sharding.py::deepspeech_param_specs`, and x [B, T, feat] and
    the log-probs [T, B, vocab+1] are whole on every rank of `group`.

    mlp1-3 are column parallel, each output all-gathered; the RNN splits
    H (`ops/rnn.py::rnn_forward_tp`); mlp5 is row parallel: this rank's
    partial product, summed over the group, then the bias and ReLU; mlp6
    and the log-softmax are replicated. The collectives' backwards are
    `parallel/collectives.py`'s. With one rank every product, sum and
    layout is `deepspeech_apply`'s."""
    n = torch.distributed.get_world_size(group)
    rank = torch.distributed.get_rank(group)

    def gather(h):
        return all_gather(h, group, dim=-1)

    h = copy_to_group(x.transpose(0, 1), group)
    for name in ("mlp1", "mlp2", "mlp3"):
        h = gather(linear(params[name], h, "relu"))
    h = rnn_forward_tp(params["rnn"], h, gather, rank, n)
    h = torch.relu(all_reduce(matmul(h, params["mlp5"]["w"]), group)
                   + params["mlp5"]["b"])
    logits = linear(params["mlp6"], h, None)
    return torch.log_softmax(logits, dim=-1)


def deepspeech_apply_streaming(params: dict, x: torch.Tensor,
                               rnn_state: Optional[torch.Tensor] = None):
    """Chunked forward with carried RNN state.

    x: [B, Tc, feat] -> (log-probs [Tc, B, vocab+1], new rnn_state). The
    linears are frame-local and the RNN unidirectional, so chunked calls
    with the state carried equal the full-utterance forward (float32,
    `rnn_impl="scan"`).
    """
    with span("model.forward"):
        x = x.transpose(0, 1)
        h = linear(params["mlp1"], x, "relu")
        h = linear(params["mlp2"], h, "relu")
        h = linear(params["mlp3"], h, "relu")
        h, rnn_state = rnn_forward_streaming(params["rnn"], h, rnn_state)
        h = linear(params["mlp5"], h, "relu")
        logits = linear(params["mlp6"], h, None)
        return torch.log_softmax(logits, dim=-1), rnn_state
