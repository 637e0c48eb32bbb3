"""Host ms a call in the model's stem (the program's "model.stem" span:
the stem's launches, which wait only where the launch queue is full),
mean over the traced window; nothing where the program has no such
span."""

from asrbench.program_spans import host_ms_per_call, records


def read(r):
    rec = records()
    if rec is None or not any(s.name == "model.stem" for s in rec.spans):
        return None
    return host_ms_per_call(r, "model.stem")
