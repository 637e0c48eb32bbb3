"""Datasets: synthetic workloads and a LibriSpeech-format reader.

The port's own copy of `gasr_tpu/data/dataset.py` (framework-neutral
numpy code, copied so that the port imports nothing of `gasr_tpu`):
`DEFAULT_CHARS`, `text_to_ids` / `ids_to_text`, `wer`, the synthetic
batches of the reference's random-tensor protocol (deterministic per
seed), and the reader of the extracted LibriSpeech layout
(<root>/<split>/<spk>/<chap>/<spk>-<chap>-<utt>.flac + .trans.txt);
audio decoding needs soundfile or torchaudio and raises a clear error
without either.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_CHARS = " abcdefghijklmnopqrstuvwxyz'"


def text_to_ids(text: str, chars: str = DEFAULT_CHARS,
                offset: int = 1) -> List[int]:
    """Characters -> ids (blank=0, so ids start at `offset`)."""
    lut = {c: i + offset for i, c in enumerate(chars)}
    return [lut[c] for c in text.lower() if c in lut]


def ids_to_text(ids: Sequence[int], chars: str = DEFAULT_CHARS,
                offset: int = 1) -> str:
    return "".join(chars[i - offset] for i in ids
                   if 0 <= i - offset < len(chars))


class SyntheticDataset:
    """Deterministic random batches in the training-batch schema."""

    def __init__(self, config, max_label_len: int = 32, seed: int = 0):
        self.config = config
        self.max_label_len = max_label_len
        self.seed = seed

    def batches(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.config
        rng = np.random.default_rng(self.seed)
        for _ in range(n):
            B, T, S = cfg.batch_size, cfg.seg_len, self.max_label_len
            yield {
                "inputs": rng.random((B, T, cfg.feat_size),
                                     dtype=np.float32),
                "labels": rng.integers(
                    1, cfg.output_size, (B, S)).astype(np.int32),
                "input_lengths": np.full(B, T, np.int32),
                "label_lengths": rng.integers(
                    S // 2, S + 1, B).astype(np.int32),
            }


class LibriSpeechDataset:
    """Reader for an extracted LibriSpeech split directory."""

    def __init__(self, root: str, split: str = "test-clean"):
        self.dir = os.path.join(root, split)
        if not os.path.isdir(self.dir):
            raise FileNotFoundError(
                f"LibriSpeech split not found at {self.dir}")
        self.items: List[Tuple[str, str]] = []   # (flac path, transcript)
        for spk in sorted(os.listdir(self.dir)):
            spk_dir = os.path.join(self.dir, spk)
            if not os.path.isdir(spk_dir):
                continue
            for chap in sorted(os.listdir(spk_dir)):
                cdir = os.path.join(spk_dir, chap)
                trans = os.path.join(cdir, f"{spk}-{chap}.trans.txt")
                if not os.path.exists(trans):
                    continue
                with open(trans) as f:
                    for line in f:
                        utt_id, _, text = line.strip().partition(" ")
                        flac = os.path.join(cdir, utt_id + ".flac")
                        if os.path.exists(flac):
                            self.items.append((flac, text))

    def __len__(self) -> int:
        return len(self.items)

    @staticmethod
    def _load_audio(path: str) -> Tuple[np.ndarray, int]:
        try:
            import soundfile as sf
            audio, sr = sf.read(path, dtype="float32")
            return np.asarray(audio, np.float32), sr
        except ImportError:
            pass
        try:
            import torchaudio
            wav, sr = torchaudio.load(path)
            return wav.numpy()[0], sr
        except ImportError as e:
            raise RuntimeError(
                "no audio decoder available (need soundfile or torchaudio)"
            ) from e

    def utterances(self, limit: Optional[int] = None
                   ) -> Iterator[Tuple[np.ndarray, int, str]]:
        for i, (path, text) in enumerate(self.items):
            if limit is not None and i >= limit:
                return
            audio, sr = self._load_audio(path)
            yield audio, sr, text


def wer(ref: str, hyp: str) -> float:
    """Word error rate via edit distance."""
    r, h = ref.split(), hyp.split()
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (r[i - 1] != h[j - 1]))
    return float(d[-1, -1]) / max(len(r), 1)
