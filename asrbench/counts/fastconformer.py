"""The yardstick's arithmetic of the `fastconformer` family and of the
decode it forces, frozen here beside `flops.py` and `bounds.py`:
  - `fastconformer`: the forward FLOPs of one batch (2 x the
    multiply-adds of every product and convolution; elementwise work
    not counted), as `flops.conformer` counts a Conformer;
  - `tp_frame`: the least time of one launch of the vocab-sharded frame
    kernel (`tp_frame_kernel`), as `bounds.py` counts its kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

from asrbench.counts.bounds import F32_FLOPS, least_s
from asrbench.counts.flops import _linear

# fields of a beam entry in the kernel's lists: key (8 bytes), packed
# backpointer (4), the nine int32 fields of its state (36)
LIST_ENTRY_BYTES = 8 + 4 + 9 * 4


def _halve(n: int) -> int:
    return (n - 1) // 2 + 1


def fastconformer(m: Dict, batch: int, frames: int) -> float:
    d, mult, K, C = (m["d_model"], m["ff_mult"], m["conv_kernel"],
                     m["stem_channels"])
    F, O = m["feat_size"], m["vocab_size"] + 1
    t1, f1 = _halve(frames), _halve(F)
    t2, f2 = _halve(t1), _halve(f1)
    t3, f3 = _halve(t2), _halve(f2)
    f = 2.0 * batch * t1 * f1 * 9 * C                  # conv 1 -> C
    f += 2.0 * batch * t2 * f2 * (9 * C + C * C)       # depthwise, pointwise
    f += 2.0 * batch * t3 * f3 * (9 * C + C * C)
    tok = batch * t3
    f += _linear(tok, C * f3, d)                       # sub_proj
    block = (2 * (_linear(tok, d, d * mult) * 2)       # two half-FFNs
             + 4 * _linear(tok, d, d)                  # q k v o
             + _linear(2 * t3 - 1, d, d)               # relative positions
             + 2.0 * tok * t3 * d                      # content scores
             + 2.0 * tok * (2 * t3 - 1) * d            # position scores
             + 2.0 * tok * t3 * d                      # attention @ v
             + _linear(tok, d, 2 * d)                  # pointwise 1
             + 2.0 * tok * K * d                       # depthwise
             + _linear(tok, d, d))                     # pointwise 2
    return f + m["num_blocks"] * block + _linear(tok, d, O)


def tp_frame(B: int, W: int, V: int, n: int) -> Tuple[float, str]:
    """One frame of the vocab-sharded prefix search over n shards: the
    frame's log-probs read once, the previous frame's n lists of W
    entries read and the n new ones written, the merged backpointers
    [B, W] written; 2 W V + 30 W operations an utterance outside the
    tensor cores (`bounds.fused_prefix_decode`'s a frame)."""
    lists = n * B * W * LIST_ENTRY_BYTES
    return least_s(B * V * 4 + 2 * lists + B * W * 4,
                   B * (2 * W * V + 30 * W), F32_FLOPS)
