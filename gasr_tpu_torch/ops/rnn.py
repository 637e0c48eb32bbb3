"""Elman RNN: multi-layer tanh recurrence over time.

h_t = tanh(x_t @ W_ih + h_{t-1} @ W_hh + b_ih + b_hh), stacked layers,
zero initial state, returning the full top-layer hidden history.
Weights keep the JAX package's layout: W_ih [in, H], W_hh [H, H].

The input projection x @ W_ih for all T is one GEMM outside the
recurrence. The recurrence itself is:
  - impl="scan": a Python loop of float32 `torch.matmul` + tanh steps
    (the JAX package's `lax.scan` path);
  - impl="pallas": the hand-written CUDA recurrence kernel
    (`ops/cuda/rnn_scan.py`, W_hh held in bf16, float32 accumulate);
    its plain version runs for CPU tensors.
`rnn_forward_streaming` carries the hidden state across chunks with the
float32 loop, as the JAX package streams with its `lax.scan`.
"""

from __future__ import annotations

from typing import Optional

import torch

from gasr_tpu_torch.ops.cuda.rnn_scan import rnn_scan
from gasr_tpu_torch.ops.linear import uniform_init


def rnn_cell_init(generator: torch.Generator, input_size: int,
                  hidden_size: int, device="cpu") -> dict:
    """torch.nn.RNN default init: U(-1/sqrt(H), 1/sqrt(H)) on all tensors."""
    bound = 1.0 / (hidden_size ** 0.5)
    shapes = {"w_ih": (input_size, hidden_size),
              "w_hh": (hidden_size, hidden_size),
              "b_ih": (hidden_size,), "b_hh": (hidden_size,)}
    return {k: uniform_init(generator, s, bound, device)
            for k, s in shapes.items()}


def rnn_cell(params: dict, x_t: torch.Tensor,
             h_prev: torch.Tensor) -> torch.Tensor:
    """One Elman step. x_t: [B, in], h_prev: [B, H] -> [B, H]."""
    pre = (torch.matmul(x_t, params["w_ih"])
           + torch.matmul(h_prev, params["w_hh"])
           + params["b_ih"] + params["b_hh"])
    return torch.tanh(pre)


def rnn_init(generator: torch.Generator, input_size: int, hidden_size: int,
             num_layers: int = 1, bidirectional: bool = False,
             device="cpu") -> dict:
    """Params: {'layers': [cell, ...]}. Layer l>0 takes H inputs."""
    if bidirectional:
        raise NotImplementedError(
            "bidirectional RNNs are not ported yet (ROADMAP.md Queue 1 "
            "item 3)")
    layers = [rnn_cell_init(generator, input_size if l == 0 else hidden_size,
                            hidden_size, device)
              for l in range(num_layers)]
    return {"layers": layers}


def _input_projection(cell: dict, x: torch.Tensor) -> torch.Tensor:
    """[T, B, in] -> [T, B, H]: x @ W_ih + b_ih + b_hh for all T at once."""
    return torch.matmul(x, cell["w_ih"]) + cell["b_ih"] + cell["b_hh"]


def _scan_one_direction(cell: dict, x: torch.Tensor, h0: torch.Tensor,
                        return_final: bool = False):
    """One layer, forward in time: [T, B, in] -> [T, B, H] (and the last
    hidden state [B, H] with return_final)."""
    xw = _input_projection(cell, x)
    w_hh = cell["w_hh"]
    out = torch.empty_like(xw)
    h = h0
    for t in range(xw.shape[0]):
        h = torch.tanh(xw[t] + torch.matmul(h, w_hh))
        out[t] = h
    if return_final:
        return out, h
    return out


def rnn_forward(params: dict, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                impl: str = "scan") -> torch.Tensor:
    """x: [T, B, input_size] time-major -> top-layer history [T, B, H].

    impl: 'scan' (float32 loop) or 'pallas' (the CUDA recurrence kernel
    on CUDA tensors, its plain bf16-cast version on CPU tensors).
    """
    if "layers_rev" in params:
        raise NotImplementedError(
            "bidirectional RNNs are not ported yet (ROADMAP.md Queue 1 "
            "item 3)")
    if impl not in ("scan", "pallas"):
        raise ValueError(f"unknown rnn impl {impl!r}")
    B = x.shape[1]
    out = x
    for cell in params["layers"]:
        H = cell["w_hh"].shape[0]
        h_init = (torch.zeros(B, H, dtype=x.dtype, device=x.device)
                  if h0 is None else h0)
        if impl == "pallas":
            out = rnn_scan(_input_projection(cell, out), cell["w_hh"],
                           h_init)
        else:
            out = _scan_one_direction(cell, out, h_init)
    return out


def rnn_forward_streaming(params: dict, x: torch.Tensor,
                          h_stack: Optional[torch.Tensor] = None):
    """Unidirectional forward carrying hidden state across chunks.

    x: [Tc, B, in]; h_stack: [num_layers, B, H] (None -> zeros).
    Returns (out [Tc, B, H], new h_stack); chunked calls equal one
    full-sequence `rnn_forward(..., impl="scan")`.
    """
    if "layers_rev" in params:
        raise ValueError("bidirectional RNNs cannot stream")
    layers = params["layers"]
    B = x.shape[1]
    H = layers[0]["w_hh"].shape[0]
    if h_stack is None:
        h_stack = torch.zeros(len(layers), B, H, dtype=x.dtype,
                              device=x.device)
    out = x
    finals = []
    for l, cell in enumerate(layers):
        out, h_fin = _scan_one_direction(cell, out, h_stack[l],
                                         return_final=True)
        finals.append(h_fin)
    return out, torch.stack(finals)
