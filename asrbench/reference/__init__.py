"""The plain reference: the acoustic models, the decoder and the training
step in plain PyTorch, importing nothing of the program.

A model family is the module `reference/<family>.py`, found by the name
a configuration's "family" gives. It exposes:
  - `spec(model)`: its weight tree's leaves (`reference/spec.py`);
  - `apply(params, x, model, precision)`: the forward, x [B, T, F] ->
    log-probs [T', B, V+1];
  - `forward_flops(model, batch, frames)`: the frozen FLOPs of one
    forward (`counts/flops.py`);
  - `output_frames(frames)`: T' of T feature frames.
"""

import importlib

FAMILY_API = ("spec", "apply", "forward_flops", "output_frames")


def family(name: str):
    """The module of model family `name`; an unknown family is an error,
    never another family's reference."""
    try:
        mod = importlib.import_module(f"asrbench.reference.{name}")
    except ModuleNotFoundError as e:
        raise KeyError(f"asrbench: no model family {name!r} "
                       f"(asrbench/reference/{name}.py)") from e
    missing = [k for k in FAMILY_API if not hasattr(mod, k)]
    if missing:
        raise KeyError(f"asrbench: asrbench/reference/{name}.py is no model "
                       f"family: it lacks {', '.join(missing)}")
    return mod
