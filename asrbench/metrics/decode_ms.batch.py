"""Host ms from a fence at the decode's start to every transcript on the
host (`ctc_beam_search` and `decode_to_lists`), mean a call."""


def read(r):
    return r.mean_ms("decode")
