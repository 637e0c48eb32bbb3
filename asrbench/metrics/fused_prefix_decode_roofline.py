"""The decode kernel's share of its roofline: the least time of one call
at the cell's shapes (`counts.bounds.fused_prefix_decode`: log-probs
read once, beam state and backpointers written once) / the profiler's
device time of `fused_prefix_decode` a launch, in %."""

from asrbench.counts import bounds, flops

KERNELS = ("fused_prefix_decode_kernel",)


def read(r):
    if r.trace is None:
        return None
    sec, launches = r.trace.seconds(*KERNELS)
    if not launches:
        return None
    t = r.traffic
    T = flops.output_frames(r.family, t["frames"])
    least, _ = bounds.fused_prefix_decode(
        T, t["batch"], r.model["vocab_size"] + 1,
        r.cell.config["program"]["beam_width"])
    return 100.0 * least * launches / sec
