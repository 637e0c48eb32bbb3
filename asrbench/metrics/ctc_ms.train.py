"""Device ms from the step's `mark("forward")` to its `mark("ctc")`: the
CTC loss's forward recursion, mean a step."""


def read(r):
    return r.mean_ms("ctc_train")
