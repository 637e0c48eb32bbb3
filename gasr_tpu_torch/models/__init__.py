"""Model families. Only `deepspeech` is ported so far; the others raise
`NotImplementedError` naming their ROADMAP.md queue item."""

from typing import Optional

import torch

from gasr_tpu_torch.config import resolve_device
from gasr_tpu_torch.models.deepspeech import (  # noqa: F401
    deepspeech_apply, deepspeech_init,
)

_NOT_PORTED = {
    "bilstm": "ROADMAP.md Queue 1 item 9",
    "deepspeech2": "ROADMAP.md Queue 1 item 9",
    "conformer_s": "ROADMAP.md Queue 1 item 10",
    "conformer_l": "ROADMAP.md Queue 1 item 10",
    "conformer": "ROADMAP.md Queue 1 item 10",
}


def _check_family(name: str) -> None:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet ({_NOT_PORTED[name]})")
    if name != "deepspeech":
        raise ValueError(f"unknown model {name!r}")


def model_init(config, generator: Optional[torch.Generator] = None,
               device: Optional[str] = None):
    """Params for the configured model family, on `device` (default:
    config.device, which defaults to "cuda" and raises without a card).
    Drawn from `generator` (default: seeded with config.seed)."""
    _check_family(config.model)
    dev = resolve_device(device or config.device)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    return deepspeech_init(generator, config, dev)


def model_apply(config, params, x, **kw):
    """Apply the configured model: x [B, T, F] -> log-probs [T, B, V+1]."""
    _check_family(config.model)
    return deepspeech_apply(params, x, **kw)
