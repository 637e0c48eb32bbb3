"""The lists' own ms a chunk in `decode_to_lists` (every stream's partial
transcript): the program's "decode.lists.build" span (host ms) plus the
device ms of the lists' pageable copy to the host, mean over the traced
window; the fetch's wait for the decode's kernels is left out."""

from asrbench.program_spans import lists_ms_per_call


def read(r):
    return lists_ms_per_call(r)
