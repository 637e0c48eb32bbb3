"""Model families: `deepspeech`, `bilstm`, `deepspeech2` and the
conformers (`conformer_s`, `conformer_l`, `conformer`), the JAX
package's five, all ported; one conformer preset of the port's own,
`parakeet_ctc_1.1b` (NeMo's FastConformer-XXL CTC, `models/conformer.py`);
and one family of the port's own, wav2vec 2.0 CTC on the raw waveform,
preset `wav2vec2_large_lv60` (`models/wav2vec2.py`)."""

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
from gasr_tpu_torch.models.wav2vec2 import (  # noqa: F401
    INPUT as WAV2VEC2_INPUT, PRESETS as WAV2VEC2, wav2vec2_apply,
    wav2vec2_init,
)
from gasr_tpu_torch.runtime.profiler import span

CONFORMERS = ("conformer_s", "conformer_l", "conformer",
              "parakeet_ctc_1.1b")

_INIT = {"deepspeech": deepspeech_init, "bilstm": bilstm_init,
         "deepspeech2": ds2_init, **{c: conformer_init for c in CONFORMERS},
         **{w: wav2vec2_init for w in WAV2VEC2}}
_APPLY = {"deepspeech": deepspeech_apply, "bilstm": bilstm_apply,
          "deepspeech2": ds2_apply}
# what a family reads, where it declares it: "waveform" (raw samples in
# frames of input_size); the others read log-mel features
_INPUT = {w: WAV2VEC2_INPUT for w in WAV2VEC2}


def _check_family(name: str) -> None:
    if name not in _INIT:
        raise ValueError(f"unknown model {name!r}")


def model_input(name: str) -> str:
    """"waveform" or "logmel": what the model `name` takes as x."""
    _check_family(name)
    return _INPUT.get(name, "logmel")


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
        if config.model in WAV2VEC2:
            return wav2vec2_apply(config, params, x, **kw)
        return _APPLY[config.model](params, x, **kw)
