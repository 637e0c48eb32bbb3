"""The Elman recurrence kernel's share of its roofline: the least time of
one call at the cell's shapes (`counts.bounds.rnn_scan`, bound by its
operations) / the profiler's device time of `rnn_scan` a launch, in %."""

from asrbench.counts import bounds

KERNELS = ("rnn_scan_kernel", "rnn_stream_kernel")


def read(r):
    if r.trace is None:
        return None
    sec, launches = r.trace.seconds(*KERNELS)
    if not launches:
        return None
    t = r.traffic
    least, _ = bounds.rnn_scan(t["frames"], t["batch"],
                               r.model["rnn_hidden_size"])
    return 100.0 * least * launches / sec
