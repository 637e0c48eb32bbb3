"""The vocab-sharded frame kernel's share of its roofline: the least time
of one frame at the cell's B, W, V and n = ceil(V / 128) shards
(`counts.fastconformer.tp_frame`) x the frames of the window's decodes
(T' of every T' + 1 launches: the last is the closing merge) / the
profiler's device time of `tp_frame_kernel`, in %."""

from asrbench.counts import fastconformer as counts
from asrbench.counts import flops

KERNELS = ("tp_frame_kernel",)
WINDOW_IDS = 128


def read(r):
    if r.trace is None:
        return None
    sec, launches = r.trace.seconds(*KERNELS)
    if not launches:
        return None
    t = r.traffic
    T = flops.output_frames(r.family, t["frames"])
    V = r.model["vocab_size"] + 1
    least, _ = counts.tp_frame(t["batch"],
                               r.cell.config["program"]["beam_width"], V,
                               -(-V // WINDOW_IDS))
    return 100.0 * least * launches * T / (T + 1) / sec
