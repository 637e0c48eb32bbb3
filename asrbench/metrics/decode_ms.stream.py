"""Host ms from a fence at the chunk's decode to every stream's partial
transcript on the host (`streaming_step` and `decode_to_lists`), mean
a chunk."""


def read(r):
    return r.mean_ms("decode")
