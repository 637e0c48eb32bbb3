"""WER evaluation harness, the port of `gasr_tpu/eval.py`.

  - `evaluate_batch`: log-probs + reference texts -> corpus WER, with or
    without a bigram shallow-fusion table (`decoder/lm.py`);
  - `evaluate_librispeech`: end to end (audio -> native log-mel -> model
    -> beam decode -> WER) over a LibriSpeech split when a corpus is
    available locally;
  - `parity_check`: transcript parity between the port's beam search
    and the native C++ decoder (`gasr_tpu_torch.native`).

    python -m gasr_tpu_torch.eval [--device cpu]

runs the parity gate on random log-probs when no corpus is given, as
JAX's `main` does; `--librispeech <root>` scores a split instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gasr_tpu_torch import native
from gasr_tpu_torch.config import Config, resolve_device
from gasr_tpu_torch.data.dataset import (DEFAULT_CHARS, LibriSpeechDataset,
                                         ids_to_text, wer)
from gasr_tpu_torch.data.features import add_context
from gasr_tpu_torch.decoder import ctc_beam_search
from gasr_tpu_torch.decoder.beam_search import decode_to_lists
from gasr_tpu_torch.models import model_apply, model_init


def evaluate_batch(log_probs: torch.Tensor, references: Sequence[str],
                   beam_width: int = 16, blank_id: int = 0,
                   chars: str = DEFAULT_CHARS,
                   lm_bias=None) -> Dict[str, object]:
    """log_probs [T, B, V] (on the device the decode should run on);
    references: B transcript strings; lm_bias: optional [V+1, V]
    shallow-fusion table passed through to the beam search."""
    res = ctc_beam_search(log_probs, beam_width=beam_width,
                          blank_id=blank_id, lm_bias=lm_bias)
    wers, hyps = [], []
    for (ids, _score), ref in zip(decode_to_lists(res), references):
        hyp = ids_to_text(ids, chars)
        hyps.append(hyp)
        wers.append(wer(ref.lower(), hyp))
    return {"wer": float(np.mean(wers)), "n": len(wers), "hyps": hyps}


def parity_check(log_probs: np.ndarray, beam_width: int = 16,
                 blank_id: int = 0, num_threads: int = 4,
                 device: str = "cuda") -> Dict:
    """Transcript parity: the port's beam search (on `device`) against
    the native C++ decoder. Returns {'match_rate': fraction of exactly
    matching transcripts, 'mismatches': [(b, port_ids, native_ids)]}."""
    res = ctc_beam_search(
        torch.from_numpy(np.asarray(log_probs, np.float32)).to(
            resolve_device(device)), beam_width=beam_width,
        blank_id=blank_id)
    port_out = decode_to_lists(res)
    tokens, lens, _ = native.cpu_beam_decode_batch(
        log_probs, beam_width=beam_width, blank_id=blank_id,
        num_threads=num_threads)
    mismatches = []
    B = log_probs.shape[1]
    for b in range(B):
        native_ids = tokens[b, :lens[b]].tolist()
        if port_out[b][0] != native_ids:
            mismatches.append((b, port_out[b][0], native_ids))
    return {"match_rate": 1.0 - len(mismatches) / max(B, 1),
            "mismatches": mismatches}


def evaluate_librispeech(config: Config, params, root: str,
                         split: str = "test-clean",
                         limit: Optional[int] = 50,
                         sample_rate: int = 16000) -> Dict[str, float]:
    """End-to-end WER on a local LibriSpeech split (features via the
    native front end, one utterance at a time, on `config.device`).
    `sample_rate` is taken and unused, as in the JAX package: each file's
    own rate goes to the front end."""
    dev = resolve_device(config.device)
    wers = []
    for audio, sr, text in LibriSpeechDataset(root, split).utterances(
            limit=limit):
        feats = native.logmel(audio, sample_rate=sr,
                              n_mels=config.input_size)
        x = add_context(torch.from_numpy(feats)[None].to(dev),
                        config.n_context)
        with torch.no_grad():
            lp = model_apply(config, params, x)
        res = ctc_beam_search(lp, beam_width=config.beam_width,
                              blank_id=config.blank_id)
        ids, _ = decode_to_lists(res)[0]
        wers.append(wer(text.lower(), ids_to_text(ids)))
    return {"wer": float(np.mean(wers)) if wers else float("nan"),
            "n": len(wers)}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--librispeech", default=None,
                    help="path to extracted LibriSpeech root")
    ap.add_argument("--split", default="test-clean")
    ap.add_argument("--limit", type=int, default=20)
    ap.add_argument("--beam", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.librispeech:
        cfg = Config(model="bilstm", input_size=80, n_context=0,
                     rnn_hidden_size=256, rnn_num_layers=2,
                     bidirectional=True, vocab_size=28,
                     beam_width=args.beam, device=args.device)
        params = model_init(cfg, torch.Generator().manual_seed(0))
        out = evaluate_librispeech(cfg, params, args.librispeech,
                                   args.split, args.limit)
    else:
        # no corpus: run the decoder parity gate on random logits
        rng = np.random.default_rng(0)
        lp = rng.standard_normal((50, 8, 29)).astype(np.float32)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        res = parity_check(lp, beam_width=args.beam, device=args.device)
        out = {"parity_match_rate": res["match_rate"],
               "mismatches": len(res["mismatches"])}
    print(out)
    return out


if __name__ == "__main__":
    main()
