"""Host ms a chunk in Python's cyclic collector: the program's "gc"
spans (one a collection, from its gc.callbacks start to its stop) in the
traced window / the chunks in it."""

from asrbench.program_spans import host_ms_per_call


def read(r):
    return host_ms_per_call(r, "gc")
