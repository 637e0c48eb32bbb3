"""Model families: `deepspeech`, `bilstm`, `deepspeech2` and the
conformers (`conformer_s`, `conformer_l`, `conformer`), the JAX
package's five, all ported; and one conformer preset of the port's own,
`parakeet_ctc_1.1b` (NeMo's FastConformer-XXL CTC, `models/conformer.py`)."""

from typing import Optional

import torch

from gasr_tpu_torch.config import resolve_device
from gasr_tpu_torch.models.bilstm import bilstm_apply, bilstm_init
from gasr_tpu_torch.models.conformer import (  # noqa: F401
    conformer_apply, conformer_init,
)
from gasr_tpu_torch.models.deepspeech import (  # noqa: F401
    deepspeech_apply, deepspeech_init,
)
from gasr_tpu_torch.models.deepspeech2 import ds2_apply, ds2_init
from gasr_tpu_torch.runtime.profiler import span

CONFORMERS = ("conformer_s", "conformer_l", "conformer",
              "parakeet_ctc_1.1b")

_INIT = {"deepspeech": deepspeech_init, "bilstm": bilstm_init,
         "deepspeech2": ds2_init, **{c: conformer_init for c in CONFORMERS}}
_APPLY = {"deepspeech": deepspeech_apply, "bilstm": bilstm_apply,
          "deepspeech2": ds2_apply}


def _check_family(name: str) -> None:
    if name not in _INIT:
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
    return _INIT[config.model](generator, config, dev)


def model_apply(config, params, x, **kw):
    """Apply the configured model: x [B, T, F] -> log-probs [T', B, V+1]."""
    _check_family(config.model)
    with span("model.forward"):
        if config.model in CONFORMERS:
            return conformer_apply(config, params, x, **kw)
        return _APPLY[config.model](params, x, **kw)
