"""Device ms from the step's `mark("ctc")` to its `mark("backward")`:
autograd's backward, the CTC loss's included, mean a step."""


def read(r):
    return r.mean_ms("backward_train")
