"""Batch transcription in three stages (see `_batch.py`):
`models.model_apply` at the configuration's compute dtype, then
`ctc_beam_search` (with the utterances' lengths, where the mix has
them), then `decode_to_lists`."""

from __future__ import annotations

import torch

from asrbench.common import compute_dtype
from asrbench.loops._batch import BatchLoad


class Load(BatchLoad):

    def __init__(self, cell, params, seed: int, device: str, spans):
        super().__init__(cell, params, seed, device, spans)
        from gasr_tpu_torch.models import model_apply
        self._apply = model_apply
        self._dtype = compute_dtype(self.cfg)

    def forward(self, x):
        with torch.no_grad():
            return self._apply(self.cfg, self.params, x,
                               rnn_impl=self.cfg.rnn_impl,
                               compute_dtype=self._dtype)
