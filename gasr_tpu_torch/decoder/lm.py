"""Character n-gram LM producers for shallow-fusion decoding.

The port's own copy of `gasr_tpu/decoder/lm.py` (numpy code, copied so
that the port imports nothing of `gasr_tpu`). The decoder's `lm_bias`
slot (`beam_search.ctc_beam_search` / `streaming_step`) is a [V+1, V]
additive table applied on every append: row = previous vocab id + 1
(row 0 = sentence start / empty prefix), column = appended vocab id.
Two producers fill it:

  - `bigram_bias_from_text`: maximum-likelihood character bigram with
    add-k smoothing, estimated from an in-memory text corpus;
  - `bigram_bias_from_arpa`: a minimal ARPA n-gram reader (1- and
    2-gram sections, log10 probs + backoff), the interchange format
    every KenLM/SRILM toolchain emits.

Both return weight * ln P(c | prev) over the char columns; the blank
column (never appended) and non-char ids stay 0. The decoder quantizes
the table to bfloat16 once, for the decode kernel and its plain version
alike (see `beam_search.ctc_beam_search`).

Scope: the fusion state is the last character only (bigram); the ARPA
reader ingests the 1- and 2-gram sections and ignores higher orders, as
the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from gasr_tpu_torch.data.dataset import DEFAULT_CHARS, text_to_ids

LN10 = float(np.log(10.0))


def bigram_bias_from_text(texts: Iterable[str], vocab_size: int,
                          chars: str = DEFAULT_CHARS, offset: int = 1,
                          add_k: float = 0.5,
                          weight: float = 1.0) -> np.ndarray:
    """Estimate a [V+1, V] shallow-fusion table from raw transcripts.

    vocab_size: the decoder's V (model output width, INCLUDING blank).
    Char c maps to vocab id chars.index(c) + offset. Every non-blank
    column gets add-k mass so unseen continuations carry a finite
    penalty instead of -inf (beam search stays total).
    """
    V = vocab_size
    counts = np.zeros((V + 1, V), np.float64)
    for text in texts:
        prev = -1
        for i in text_to_ids(text, chars, offset):
            counts[prev + 1, i] += 1.0
            prev = i
    cols = np.ones((V,), bool)
    if 0 <= 0 < V:
        cols[0] = False                     # blank column: never appended
    n_cols = int(cols.sum())
    sm = counts[:, cols] + add_k
    logp = np.log(sm / sm.sum(axis=1, keepdims=True))
    bias = np.zeros((V + 1, V), np.float32)
    bias[:, cols] = (weight * logp).astype(np.float32)
    return bias


def _read_arpa_sections(lines: Iterable[str]):
    """Yield (order, token_tuple, log10_prob, log10_backoff)."""
    order = 0
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("\\end\\"):
            continue
        if line.startswith("\\") and line.endswith("-grams:"):
            order = int(line[1:].split("-")[0])
            continue
        if line.startswith("\\") or order == 0:
            continue
        parts = line.split("\t")
        if len(parts) < 2:
            parts = line.split()
            if len(parts) < order + 1:
                continue
            logp, toks = float(parts[0]), tuple(parts[1:1 + order])
            bo = float(parts[1 + order]) if len(parts) > 1 + order else 0.0
        else:
            logp = float(parts[0])
            toks = tuple(parts[1].split())
            bo = float(parts[2]) if len(parts) > 2 else 0.0
        if len(toks) == order:
            yield order, toks, logp, bo


def bigram_bias_from_arpa(path: str, vocab_size: int,
                          chars: str = DEFAULT_CHARS, offset: int = 1,
                          weight: float = 1.0,
                          space_token: str = "<space>") -> np.ndarray:
    """Read a character-level ARPA file into the [V+1, V] bias table.

    Tokens: single characters (the literal space character may be
    spelled `space_token`), plus the standard `<s>`/`</s>`/`<unk>`
    markers; `<s>` feeds the start row, `</s>` is ignored (CTC prefixes
    have no end event). Backoff is applied for missing bigrams:
    log P(c|p) = log P_bo(p) + log P_uni(c). Probabilities arrive in
    log10 (the ARPA convention) and leave as weight * ln P.
    """
    def tok_to_id(t: str) -> Optional[int]:
        if t == space_token:
            t = " "
        if len(t) == 1 and t in chars:
            return chars.index(t) + offset
        return None                         # <s>, </s>, <unk>, ...

    uni: Dict[int, float] = {}
    uni_bo: Dict[int, float] = {}
    bo_start = 0.0
    bi: Dict[Tuple[int, int], float] = {}
    bi_start: Dict[int, float] = {}
    with open(path) as f:
        for order, toks, logp, bo in _read_arpa_sections(f):
            if order == 1:
                i = tok_to_id(toks[0])
                if i is not None:
                    uni[i] = logp
                    uni_bo[i] = bo
                elif toks[0] == "<s>":
                    bo_start = bo
            elif order == 2:
                a = tok_to_id(toks[0])
                b = tok_to_id(toks[1])
                if b is None:
                    continue
                if a is not None:
                    bi[(a, b)] = logp
                elif toks[0] == "<s>":
                    bi_start[b] = logp

    V = vocab_size
    floor = min(uni.values()) - 2.0 if uni else -6.0
    bias = np.zeros((V + 1, V), np.float32)
    for c in range(V):
        if c == 0 or c - offset >= len(chars):
            continue
        p_uni = uni.get(c, floor)
        bias[0, c] = bi_start.get(c, bo_start + p_uni)
        for p in range(V):
            if p == 0 or p - offset >= len(chars):
                continue
            bias[p + 1, c] = bi.get((p, c), uni_bo.get(p, 0.0) + p_uni)
    return (bias * (weight * LN10)).astype(np.float32)
