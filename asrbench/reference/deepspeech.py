"""Plain DeepSpeech-1 forward (Hannun et al. 2014, arXiv:1412.5567): the
acoustic model of the `reference_large` configuration.

    h1..h3 = relu(x W + b)                     three frame-wise layers
    h4_t   = tanh(h3_t W_ih + b_ih + b_hh + h4_{t-1} W_hh), h4_{-1} = 0
    h5     = relu(h4 W5 + b5)
    out    = log_softmax(h5 W6 + b6)

Weights are the tensors the benchmark made, in its layout: a linear's
"w" is [in, out] (x @ w), the recurrence's cell is "w_ih" [in, H],
"w_hh" [H, H], "b_ih", "b_hh". Input [B, T, F], output log-probs
[T, B, V+1], time-major.

`precision` says how each product's operands are rounded
(`precision.round_to`): "linear" for the frame-wise layers and the input
projection, "recurrence" for h_{t-1} W_hh. The recurrence runs one step
at a time, as written above.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from asrbench.counts.flops import deepspeech as forward_flops  # noqa: F401
from asrbench.reference import spec as S
from asrbench.reference.precision import mm, round_to


def spec(m: Dict) -> S.Spec:
    F, L, H, V = (m["feat_size"], m["linear_size"], m["rnn_hidden_size"],
                  m["vocab_size"] + 1)
    out: S.Spec = []
    S.lin(out, ("mlp1",), F, L)
    S.lin(out, ("mlp2",), L, L)
    S.lin(out, ("mlp3",), L, H)
    h = 1.0 / math.sqrt(H)
    for name, shape in (("w_ih", (H, H)), ("w_hh", (H, H)),
                        ("b_ih", (H,)), ("b_hh", (H,))):
        out.append((("rnn", "layers", 0, name), shape, 0.0, h))
    S.lin(out, ("mlp5",), H, L)
    S.lin(out, ("mlp6",), L, V)
    return out


def output_frames(frames: int) -> int:
    return frames


def _linear(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(x, p["w"], prec) + p["b"]


def recurrence(cell: dict, x: torch.Tensor, prec_in: str, prec_rec: str,
               h0: Optional[torch.Tensor] = None):
    """x [T, B, in] -> (hidden history [T, B, H], last hidden [B, H])."""
    xw = mm(x, cell["w_ih"], prec_in) + cell["b_ih"] + cell["b_hh"]
    w = round_to(cell["w_hh"], prec_rec)
    h = torch.zeros_like(xw[0]) if h0 is None else h0
    out = []
    for t in range(xw.shape[0]):
        h = torch.tanh(xw[t] + torch.matmul(round_to(h, prec_rec), w))
        out.append(h)
    return torch.stack(out), h


def forward(params: dict, x: torch.Tensor, precision: Dict[str, str],
            h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """x [B, T, F] -> log-probs [T, B, V+1] (and the last hidden state
    with return_state, for a forward carried across chunks)."""
    lin, rec = precision["linear"], precision["recurrence"]
    h = x.transpose(0, 1)
    for name in ("mlp1", "mlp2", "mlp3"):
        h = torch.relu(_linear(params[name], h, lin))
    (cell,) = params["rnn"]["layers"]
    h, last = recurrence(cell, h, lin, rec, h0)
    h = torch.relu(_linear(params["mlp5"], h, lin))
    out = torch.log_softmax(_linear(params["mlp6"], h, lin), dim=-1)
    return (out, last) if return_state else out


def apply(params: dict, x: torch.Tensor, model: Dict,
          precision: Dict[str, str]) -> torch.Tensor:
    return forward(params, x, precision)
