"""The whole call's share of the card's dense bf16 peak: the frozen
forward FLOPs of a call x calls / window seconds / 989 TFLOP/s, in %
(the decode's work is not counted)."""

from asrbench.counts import bounds, flops


def read(r):
    t = r.traffic
    f = flops.forward(r.family, r.model, t["batch"], t["frames"])
    return 100.0 * f * r.calls / r.window_s / bounds.BF16_TENSOR_FLOPS
