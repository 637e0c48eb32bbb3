"""The yardstick's arithmetic of the `wav2vec2` family, frozen here beside
`flops.py` and `bounds.py`:
  - `wav2vec2`: the forward FLOPs of one batch (2 x the multiply-adds of
    every product and convolution; elementwise work not counted), as
    `flops.conformer` counts a Conformer;
  - `flash_mhsa`: the least time of one launch of the position-free
    attention kernel (`flash_mhsa_kernel`), as `bounds.py` counts its
    kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

from asrbench.counts.bounds import BF16_TENSOR_FLOPS, least_s
from asrbench.counts.flops import _linear

SAMPLES_PER_FRAME = 160        # a 10 ms frame of the 16 kHz waveform


def encoder_lengths(samples: int, kernels, strides) -> list:
    """Frames after each of the feature encoder's convolutions: floor((L -
    k) / s) + 1 a layer (0 once fewer samples than the kernel remain)."""
    out, n = [], samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1 if n >= k else 0
        out.append(n)
    return out


def wav2vec2(m: Dict, batch: int, frames: int) -> float:
    lens = encoder_lengths(SAMPLES_PER_FRAME * frames, m["conv_kernel"],
                           m["conv_stride"])
    f, c_in = 0.0, 1
    for n, k, c in zip(lens, m["conv_kernel"], m["conv_dim"]):
        f += 2.0 * batch * n * k * c_in * c              # feature encoder
        c_in = c
    d, T = m["d_model"], lens[-1]
    tok = batch * T
    f += _linear(tok, c_in, d)                           # projection
    f += 2.0 * tok * m["pos_kernel"] * (d // m["pos_groups"]) * d
    layer = (4 * _linear(tok, d, d)                      # q k v o
             + 2.0 * tok * T * d                         # scores
             + 2.0 * tok * T * d                         # attention @ v
             + _linear(tok, d, m["ffn_dim"])
             + _linear(tok, m["ffn_dim"], d))
    return f + m["num_blocks"] * layer + _linear(tok, d, m["vocab_size"] + 1)


def flash_mhsa(B: int, H: int, T: int, dh: int) -> Tuple[float, str]:
    """One position-free attention call: q.k and p.v at every (t, s) on
    the bf16 tensor cores; q, k, v and the output at bf16, each read or
    written once."""
    return least_s(4 * B * H * T * dh * 2, 4.0 * B * H * T * T * dh,
                   BF16_TENSOR_FLOPS)
