"""Device ms of the model's forward a call (CUDA events around
`Pipeline.log_probs` or `models.model_apply`), mean over the window."""


def read(r):
    return r.mean_ms("forward")
