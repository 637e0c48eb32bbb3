"""Host ms a step in the CTC loss (the program's "ctc.loss" span: the
recursion's T' - 1 steps issued one by one), mean over the traced
window; beside `ctc_ms.train`, the device's ms of the same phase."""

from asrbench.program_spans import host_ms_per_call


def read(r):
    return host_ms_per_call(r, "ctc.loss")
