"""Device ms of the streaming forward a chunk (CUDA events around
`deepspeech_apply_streaming`), mean over the window."""


def read(r):
    return r.mean_ms("forward")
