"""The whole chunk's share of the card's dense bf16 peak: the frozen
forward FLOPs of a chunk of every stream x chunks / window seconds /
989 TFLOP/s, in %."""

from asrbench.counts import bounds, flops


def read(r):
    t = r.traffic
    f = flops.forward(r.family, r.model, t["streams"], t["chunk_frames"])
    return 100.0 * f * r.calls / r.window_s / bounds.BF16_TENSOR_FLOPS
