"""NumPy/dict reference decoders — the numerical oracles.

The port's own copy of `gasr_tpu/decoder/numpy_oracle.py` (the port
imports nothing of the JAX package): the same functions, which give the
same results on the same log-probs. Two independent, readable
implementations used to validate the batched decoders:

1. `reference_beam_search_np` — the reference's exact algorithm
   (CTCBeamSearch.cu semantics: blank-annotated hypothesis paths,
   prob-domain merge-by-sum, post-merge top-k prune, final-frame
   trailing-blank strip; see kernelGenNextPaths .cu:404-458 and
   decode .cu:262-312). Key structural fact: the extension rules never
   create an interior blank — a path is always (collapsed prefix +
   optional trailing blank) — so hypotheses here are (tuple(prefix),
   trailing_blank) pairs.

2. `prefix_beam_search_np` — the textbook CTC prefix beam search
   (Hannun et al.), log-space, (p_blank, p_nonblank) per collapsed
   prefix. This matches the semantics of ctcdecode.CTCBeamDecoder used
   by the baseline harness (baseline/main.py:28) and is the production
   contract.

Both are deliberately simple dict implementations; correctness over speed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

NEG_INF = -float("inf")


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def reference_beam_search_np(
    probs: np.ndarray, beam_width: int, blank_id: int = 0,
    log_space: bool = False,
) -> Tuple[List[int], float]:
    """Decode one utterance with the reference's algorithm.

    probs: [T, V] probabilities (NOT log) unless log_space, in which case
    log-probabilities. Returns (best token id sequence, its merged score
    in the input domain).

    Mirrors CTCBeamSearch.cu:
      - t=0: one path per vocab symbol (kernelInitialPath .cu:337-364),
        prune to beam_width (initialPath .cu:366-401).
      - t>=1: extend each live path with every symbol under the rules of
        kernelGenNextPaths (.cu:431-449), strip a trailing blank on the
        final frame (.cu:452-456), merge identical paths by summing
        probabilities (kernelMergeSamePaths .cu:477-489), prune to
        beam_width after merging (.cu:575-576).
    Hypothesis identity = (prefix tuple, trailing_blank flag).
    Tie-break on equal scores: stable in first-seen order (the batched
    decoders document the same contract).
    """
    T, V = probs.shape
    one = 0.0 if log_space else 1.0

    def mul(a, b):
        return a + b if log_space else a * b

    def add(a, b):
        return _logaddexp(a, b) if log_space else a + b

    # beam: ordered dict (prefix, tb) -> score
    # Start from the implicit empty path; applying the extension rules at
    # t=0 reproduces kernelInitialPath exactly (V distinct paths).
    beam: Dict[Tuple[Tuple[int, ...], int], float] = {((), 0): one}

    for t in range(T):
        is_last = (t == T - 1) and T > 1
        frame = probs[t]
        cands: Dict[Tuple[Tuple[int, ...], int], float] = {}
        for (prefix, tb), score in beam.items():
            last = prefix[-1] if prefix else None
            for v in range(V):
                p = mul(score, float(frame[v]))
                if v == blank_id:
                    # extend-with-blank: collapse repeated blank or append
                    # a trailing blank (.cu:431-438)
                    new = (prefix, 1)
                else:
                    if tb == 1:
                        # replace trailing blank with the char (.cu:440-442)
                        new = (prefix + (v,), 0)
                    elif last == v:
                        # collapse repeated char (.cu:444-445)
                        new = (prefix, 0)
                    else:
                        new = (prefix + (v,), 0)       # append (.cu:446-449)
                if is_last and new[1] == 1:
                    # final-frame trailing-blank strip (.cu:452-456)
                    new = (new[0], 0)
                if new in cands:
                    cands[new] = add(cands[new], p)    # merge-by-sum
                else:
                    cands[new] = p
        # post-merge prune to beam_width, stable on first-seen order
        items = list(cands.items())
        items.sort(key=lambda kv: -kv[1] if log_space else -kv[1])
        beam = dict(items[:beam_width])

    (best_prefix, _tb), best_score = max(
        beam.items(), key=lambda kv: kv[1])
    # The reference returns the top-of-beam path; a trailing blank can
    # survive only in the T==1 corner (no strip pass ran).
    return list(best_prefix), best_score


def prefix_beam_search_np(
    log_probs: np.ndarray, beam_width: int, blank_id: int = 0,
) -> Tuple[List[int], float]:
    """Textbook CTC prefix beam search (log-space), one utterance.

    log_probs: [T, V] log-probabilities. Returns (best collapsed prefix,
    log(p_b + p_nb) of that prefix). Matches ctcdecode semantics with no
    LM and no pruning threshold.
    """
    T, V = log_probs.shape
    # prefix -> (p_blank, p_nonblank), log domain
    beam: Dict[Tuple[int, ...], Tuple[float, float]] = {(): (0.0, NEG_INF)}

    for t in range(T):
        frame = log_probs[t]
        cands: Dict[Tuple[int, ...], Tuple[float, float]] = {}

        def acc(prefix, db, dnb):
            pb, pnb = cands.get(prefix, (NEG_INF, NEG_INF))
            cands[prefix] = (_logaddexp(pb, db), _logaddexp(pnb, dnb))

        for prefix, (p_b, p_nb) in beam.items():
            total = _logaddexp(p_b, p_nb)
            last = prefix[-1] if prefix else None
            # stay via blank
            acc(prefix, total + float(frame[blank_id]), NEG_INF)
            for v in range(V):
                if v == blank_id:
                    continue
                pv = float(frame[v])
                if v == last:
                    # collapse into same prefix (non-blank path only)
                    acc(prefix, NEG_INF, p_nb + pv)
                    # extend after explicit blank
                    acc(prefix + (v,), NEG_INF, p_b + pv)
                else:
                    acc(prefix + (v,), NEG_INF, total + pv)
        items = [(k, v, _logaddexp(*v)) for k, v in cands.items()]
        items.sort(key=lambda kv: -kv[2])
        beam = {k: v for k, v, _ in items[:beam_width]}

    best_prefix, (pb, pnb) = max(
        beam.items(), key=lambda kv: _logaddexp(*kv[1]))
    return list(best_prefix), _logaddexp(pb, pnb)


def greedy_decode_np(log_probs: np.ndarray, blank_id: int = 0) -> List[int]:
    """Best-path decode: argmax per frame, collapse repeats, drop blanks."""
    ids = np.asarray(log_probs).argmax(-1)
    out, prev = [], None
    for i in ids:
        if i != prev and i != blank_id:
            out.append(int(i))
        prev = i
    return out
