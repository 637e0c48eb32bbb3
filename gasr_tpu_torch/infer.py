"""End-to-end inference pipeline: features -> acoustic model -> decoder.

`Pipeline.transcribe` is the port's main path: the DeepSpeech forward
(with `rnn_impl="pallas"` the CUDA recurrence kernel) and the prefix
beam search (on the card the fused decode and traceback kernels).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gasr_tpu_torch.config import Config, resolve_device
from gasr_tpu_torch.decoder import ctc_beam_search, greedy_decode
from gasr_tpu_torch.decoder.beam_search import decode_to_lists
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.runtime.validation import check_features

# default character vocabulary: blank + space + a-z (29 incl. apostrophe)
DEFAULT_VOCAB = ["$", " "] + [chr(c) for c in range(ord("a"), ord("z") + 1)] \
    + ["'"]


class Pipeline:
    """features [B, T, F] (tensor or array) -> transcripts, on
    `config.device` ("cuda" unless the config asks for "cpu")."""

    def __init__(self, config: Config, params=None,
                 vocab: Optional[Sequence[str]] = None,
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = resolve_device(config.device)
        self.vocab = list(vocab) if vocab is not None else (
            DEFAULT_VOCAB[:config.output_size]
            if config.output_size <= len(DEFAULT_VOCAB) else None)
        if params is None:
            params = model_init(config, generator, device=config.device)
        self.params = params

    def log_probs(self, features) -> torch.Tensor:
        check_features(features, self.config.feat_size)
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.asarray(features, np.float32))
        x = features.to(device=self.device, dtype=torch.float32)
        with torch.no_grad():
            return model_apply(self.config, self.params, x,
                               rnn_impl=self.config.rnn_impl)

    def transcribe(self, features, top: int = 1
                   ) -> List[Tuple[List[int], float]]:
        lp = self.log_probs(features)
        if self.config.decoder == "greedy":
            tokens, lengths = greedy_decode(lp, self.config.blank_id)
            toks = tokens.cpu().numpy()
            lens = lengths.cpu().numpy()
            return [(toks[b, :lens[b]].tolist(), 0.0)
                    for b in range(toks.shape[0])]
        algorithm = ("reference" if self.config.decoder == "reference"
                     else "prefix")
        res = ctc_beam_search(
            lp, beam_width=self.config.beam_width,
            blank_id=self.config.blank_id,
            max_len=self.config.decode_max_len, algorithm=algorithm)
        return decode_to_lists(res, top=top)

    def transcribe_streaming(self, feature_chunks):
        raise NotImplementedError(
            "streaming decode is not ported yet (ROADMAP.md Queue 1 item 8)")

    def transcribe_audio(self, audio_batch, sample_rate: int = 16000):
        raise NotImplementedError(
            "the audio front end is not ported yet (ROADMAP.md Queue 1 "
            "items 8 and 11)")

    def to_text(self, ids: Sequence[int]) -> str:
        if self.vocab is None:
            return " ".join(map(str, ids))
        return "".join(self.vocab[i] for i in ids)
