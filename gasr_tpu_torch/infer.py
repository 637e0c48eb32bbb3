"""End-to-end inference pipeline: features -> acoustic model -> decoder.

`Pipeline.transcribe` is the port's main path: the configured model's
forward through `models.model_apply(..., rnn_impl=config.rnn_impl)`
(deepspeech with `rnn_impl="pallas"` runs the Elman recurrence kernel,
bilstm and deepspeech2 the LSTM recurrence kernel; the conformers run in
float32 here, as JAX's Pipeline runs them) and the prefix beam search
(on the card the fused decode and traceback kernels). Nothing in it
depends on the family beyond that dispatch.
`Pipeline.transcribe_streaming` is the live-audio path: the chunked
forward with carried RNN state and, per chunk, one decode kernel launch
from the carried beam and one traceback-with-overlay launch.
`Pipeline.transcribe_audio` is the raw-audio path: the native log-mel
front end on the host per utterance, padding, then on the device cmvn
(when configured), context stacking, the forward and the beam search
with per-utterance lengths, and text.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gasr_tpu_torch import native
from gasr_tpu_torch.config import Config, resolve_device
from gasr_tpu_torch.data.features import add_context, cmvn
from gasr_tpu_torch.decoder import ctc_beam_search, greedy_decode
from gasr_tpu_torch.decoder.beam_search import (decode_to_lists,
                                                streaming_init,
                                                streaming_step)
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.models.deepspeech import deepspeech_apply_streaming
from gasr_tpu_torch.runtime.profiler import span
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
        with span("transcribe"):
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

    def transcribe_streaming(self, feature_chunks
                             ) -> List[Tuple[List[int], float]]:
        """Decode an iterable of [B, Tc, F] feature chunks with carried
        model state and carried beam state: equal to a full-utterance
        transcribe with the float32 forward, for any total length.

        Needs a streaming topology (deepspeech, unidirectional). For
        partial results call `decoder.beam_search.streaming_step`.
        """
        if self.config.model != "deepspeech" or self.config.bidirectional:
            raise ValueError(
                "streaming requires the unidirectional deepspeech model")
        state = rnn_state = None
        chunks = list(feature_chunks)
        for i, chunk in enumerate(chunks):
            with span("stream.chunk"):
                if not isinstance(chunk, torch.Tensor):
                    chunk = torch.from_numpy(np.asarray(chunk, np.float32))
                x = chunk.to(device=self.device, dtype=torch.float32)
                with torch.no_grad():
                    lp, rnn_state = deepspeech_apply_streaming(
                        self.params, x, rnn_state)
                if state is None:
                    state = streaming_init(
                        lp.shape[1], self.config.beam_width,
                        max_len=self.config.decode_max_len,
                        device=self.device)
                state, snap = streaming_step(
                    state, lp, blank_id=self.config.blank_id,
                    is_final=(i == len(chunks) - 1))
        return decode_to_lists(snap)

    def audio_features(self, audio_batch: Sequence[np.ndarray],
                       sample_rate: int = 16000):
        """The front end of `transcribe_audio`: native log-mel per
        utterance on the host, padded to the longest and moved to the
        device; cmvn over each utterance's frames when `config.cmvn`;
        n_context stacking. Returns (features [B, T, feat_size], lengths
        [B] int32, the feature frame counts), both on `self.device`."""
        feats = [native.logmel(a, sample_rate=sample_rate,
                               n_mels=self.config.input_size)
                 for a in audio_batch]
        lengths = np.array([f.shape[0] for f in feats], np.int32)
        padded = np.zeros((len(feats), int(lengths.max()),
                           self.config.input_size), np.float32)
        for i, f in enumerate(feats):
            padded[i, :f.shape[0]] = f
        x = torch.from_numpy(padded).to(self.device)
        lens = torch.from_numpy(lengths).to(self.device)
        if self.config.cmvn:
            x = cmvn(x, lengths=lens)
        return add_context(x, self.config.n_context), lens

    def transcribe_audio(self, audio_batch: Sequence[np.ndarray],
                         sample_rate: int = 16000) -> List[str]:
        """Raw waveforms -> transcripts, step for step as JAX's:
        `audio_features`, the forward, the prefix beam search with
        per-utterance lengths, text.

        The lengths are the feature frame counts, also for models that
        subsample time (deepspeech2 halves T, the conformers quarter
        it): JAX's `transcribe_audio` passes them so, and the port
        computes what it computes (ROADMAP.md Queue 3)."""
        x, lens = self.audio_features(audio_batch, sample_rate)
        res = ctc_beam_search(
            self.log_probs(x), beam_width=self.config.beam_width,
            blank_id=self.config.blank_id,
            max_len=self.config.decode_max_len, input_lengths=lens)
        return [self.to_text(ids) for ids, _ in decode_to_lists(res)]

    def to_text(self, ids: Sequence[int]) -> str:
        if self.vocab is None:
            return " ".join(map(str, ids))
        return "".join(self.vocab[i] for i in ids)


def main(argv=None):
    """A small DeepSpeech pipeline on random weights and inputs: prints
    each utterance's text and the call's time.

        python -m gasr_tpu_torch.infer [--model deepspeech] [--batch 4]
            [--frames 50] [--beam 10] [--device cuda|cpu]
    """
    import argparse

    from gasr_tpu_torch.runtime.timer import Timer

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deepspeech")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)

    cfg = Config(model=args.model, batch_size=args.batch,
                 input_size=26, n_context=1, linear_size=256,
                 rnn_hidden_size=256, vocab_size=27,
                 seg_len=args.frames, beam_width=args.beam,
                 device=args.device)
    pipe = Pipeline(cfg)
    feats = torch.rand((args.batch, args.frames, cfg.feat_size),
                       generator=torch.Generator().manual_seed(1))
    timer = Timer()
    out, dt = timer.time("transcribe", pipe.transcribe, feats)
    for b, (ids, score) in enumerate(out):
        print(f"utt {b}: {pipe.to_text(ids)!r}  score={score:.3f}")
    print(f"[{dt:.3f}s transcribe on {pipe.device}, the first call]")


if __name__ == "__main__":
    main()
