"""Model families. `deepspeech` and the conformers (`conformer_s`,
`conformer_l`, `conformer`) are ported; the others raise
`NotImplementedError` naming their ROADMAP.md queue item."""

from typing import Optional

import torch

from gasr_tpu_torch.config import resolve_device
from gasr_tpu_torch.models.conformer import (  # noqa: F401
    conformer_apply, conformer_init,
)
from gasr_tpu_torch.models.deepspeech import (  # noqa: F401
    deepspeech_apply, deepspeech_init,
)

CONFORMERS = ("conformer_s", "conformer_l", "conformer")

_NOT_PORTED = {
    "bilstm": "ROADMAP.md Queue 1 item 10",
    "deepspeech2": "ROADMAP.md Queue 1 item 10",
}


def _check_family(name: str) -> None:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet ({_NOT_PORTED[name]})")
    if name != "deepspeech" and name not in CONFORMERS:
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
    if config.model in CONFORMERS:
        return conformer_init(generator, config, dev)
    return deepspeech_init(generator, config, dev)


def model_apply(config, params, x, **kw):
    """Apply the configured model: x [B, T, F] -> log-probs [T', B, V+1]."""
    _check_family(config.model)
    if config.model in CONFORMERS:
        return conformer_apply(config, params, x, **kw)
    return deepspeech_apply(params, x, **kw)
