"""The relative-position attention kernel's share of its roofline: the
least time of one launch at the cell's shapes
(`counts.bounds.flash_mhsa_rel`) / the profiler's device time of
`flash_mhsa_rel` a launch (17 a forward), in %."""

from asrbench.counts import bounds, flops

KERNELS = ("flash_mhsa_rel_kernel",)


def read(r):
    if r.trace is None:
        return None
    sec, launches = r.trace.seconds(*KERNELS)
    if not launches:
        return None
    t, m = r.traffic, r.model
    least, _ = bounds.flash_mhsa_rel(
        t["batch"], m["num_heads"], flops.output_frames(r.family,
                                                        t["frames"]),
        m["d_model"] // m["num_heads"])
    return 100.0 * least * launches / sec
