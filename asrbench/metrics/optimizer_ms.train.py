"""Host ms a step in AdamW (the program's "optimizer.step" span: the
grads handed over, `step()` and `zero_grad`), mean over the traced
window; the clip before it, which waits behind the backward's queued
launches, is left out."""

from asrbench.program_spans import host_ms_per_call


def read(r):
    return host_ms_per_call(r, "optimizer.step")
