"""The position-free attention kernel's share of its roofline: the least
time of one launch at the cell's shapes (`counts.wav2vec2.flash_mhsa`:
B, the heads, T' and d_h; bound by its operations) / the profiler's
device time of `flash_mhsa_kernel` a launch (one a layer), in %."""

from asrbench.counts import flops
from asrbench.counts import wav2vec2 as counts

KERNELS = ("flash_mhsa_kernel",)


def read(r):
    if r.trace is None:
        return None
    sec, launches = r.trace.seconds(*KERNELS)
    if not launches:
        return None
    t, m = r.traffic, r.model
    least, _ = counts.flash_mhsa(
        t["batch"], m["num_heads"], flops.output_frames(r.family,
                                                        t["frames"]),
        m["d_model"] // m["num_heads"])
    return 100.0 * least * launches / sec
