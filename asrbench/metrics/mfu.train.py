"""The whole step's share of the cards' dense bf16 peak: 3 x the frozen
forward FLOPs of the global batch ("batch" a rank x "world" ranks, one
rank where the mix has no "world") x steps / window seconds / (the
cell's cards x 989 TFLOP/s), in %."""

from asrbench.counts import bounds, flops


def read(r):
    t = r.traffic
    f = flops.train_step(r.family, r.model, t["batch"] * t.get("world", 1),
                         t["frames"])
    return (100.0 * f * r.calls / r.window_s
            / (r.cell.chips * bounds.BF16_TENSOR_FLOPS))
