"""The positional convolution kernel's share of its roofline: the least
time of one launch at the cell's shapes / the profiler's device time of
`pos_conv_kernel` a launch (one a forward), in %. The least time is
bound by the operations: 2 B T' K (d / groups) d on the bf16 tensor
cores (h and the output at bf16 and the weight, each moved once, take
less); nothing where the kernel did not run."""

from asrbench.counts import flops
from asrbench.counts.bounds import BF16_TENSOR_FLOPS, least_s

KERNELS = ("pos_conv_kernel",)


def read(r):
    if r.trace is None:
        return None
    sec, launches = r.trace.seconds(*KERNELS)
    if not launches:
        return None
    t, m = r.traffic, r.model
    B = t["batch"]
    T = flops.output_frames(r.family, t["frames"])
    K, d = m["pos_kernel"], m["d_model"]
    cg = d // m["pos_groups"]
    least, _ = least_s(2 * (2 * B * T * d) + K * cg * d * 2 + d * 2,
                       2.0 * B * T * K * cg * d, BF16_TENSOR_FLOPS)
    return 100.0 * least * launches / sec
