"""Share of the traced window in which no operation ran on the device:
1 - the union of kernel, copy and fill intervals / the window, in %."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
