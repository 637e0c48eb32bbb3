"""Analytic forward FLOPs of one batch: 2 x the multiply-adds of every
product, convolution and recurrence; elementwise work is not counted.
A frozen copy of the deepspeech and conformer branches of the port's
`runtime/flops.py` (the JAX package's counts), over the sizes in a
configuration's "model" entry.

A training step counts 3 x the forward (the backward takes about two
forwards' products; the CTC loss and the optimizer count as zero).
"""

from __future__ import annotations

from typing import Dict


def _linear(tokens: float, d_in: int, d_out: int) -> float:
    return 2.0 * tokens * d_in * d_out


def deepspeech(m: Dict, batch: int, frames: int) -> float:
    F, L, H, O = (m["feat_size"], m["linear_size"], m["rnn_hidden_size"],
                  m["vocab_size"] + 1)
    tok = batch * frames
    f = _linear(tok, F, L) + _linear(tok, L, L) + _linear(tok, L, H)
    f += 2.0 * tok * H * H + 2.0 * tok * H * H       # input + recurrent
    return f + _linear(tok, H, L) + _linear(tok, L, O)


def conformer(m: Dict, batch: int, frames: int) -> float:
    d, mult, K = m["d_model"], m["ff_mult"], m["conv_kernel"]
    F, O = m["feat_size"], m["vocab_size"] + 1
    t1, f1 = -(-frames // 2), -(-F // 2)
    t2, f2 = -(-t1 // 2), -(-f1 // 2)
    f = 2.0 * batch * t1 * f1 * 9 * 1 * d              # conv1
    f += 2.0 * batch * t2 * f2 * 9 * d * d             # conv2
    tok = batch * t2
    f += _linear(tok, d * f2, d)                       # sub_proj
    block = (2 * (_linear(tok, d, d * mult) * 2)       # two half-FFNs
             + 4 * _linear(tok, d, d)                  # q k v o
             + _linear(2 * t2 - 1, d, d)               # relative positions
             + 2.0 * tok * t2 * d                      # content scores
             + 2.0 * tok * (2 * t2 - 1) * d            # position scores
             + 2.0 * tok * t2 * d                      # attention @ v
             + _linear(tok, d, 2 * d)                  # pointwise 1
             + 2.0 * tok * K * d                       # depthwise
             + _linear(tok, d, d))                     # pointwise 2
    return f + m["num_blocks"] * block + _linear(tok, d, O)


def forward(family: str, m: Dict, batch: int, frames: int) -> float:
    """The forward FLOPs of `family` (its `forward_flops`, one of the
    counts above for the two families here)."""
    from asrbench import reference
    return reference.family(family).forward_flops(m, batch, frames)


def train_step(family: str, m: Dict, batch: int, frames: int) -> float:
    return 3.0 * forward(family, m, batch, frames)


def output_frames(family: str, frames: int) -> int:
    """Log-prob frames of `frames` feature frames."""
    from asrbench import reference
    return reference.family(family).output_frames(frames)
