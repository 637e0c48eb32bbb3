"""The whole step's share of the card's dense bf16 peak: 3 x the frozen
forward FLOPs x steps / window seconds / 989 TFLOP/s, in %."""

from asrbench.counts import bounds, flops


def read(r):
    t = r.traffic
    f = flops.train_step(r.family, r.model, t["batch"], t["frames"])
    return 100.0 * f * r.calls / r.window_s / bounds.BF16_TENSOR_FLOPS
