"""The port's NumPy oracle decoders (`gasr_tpu_torch/decoder/numpy_oracle.py`)
against the JAX package's on the same seeded log-probs, and the port's
batched decoders held to them, as tests/test_decoder.py holds JAX's.

Tolerances: the oracles are the same float64 Python arithmetic, so their
results are equal; the batched decoders' scores are float32 sums in
another order, held at rtol 1e-3 (tests/test_decoder.py's bound).
"""

import numpy as np
import pytest
import torch

from gasr_tpu.decoder import numpy_oracle as joracle

from gasr_tpu_torch.decoder import ctc_beam_search, greedy_decode
from gasr_tpu_torch.decoder import numpy_oracle as toracle
from gasr_tpu_torch.decoder.beam_search import decode_to_lists

ORACLES = ("reference_prob", "reference_log", "prefix", "greedy")


def _lp(rng, T, B, V):
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _call(mod, name, lp, W):
    if name == "reference_prob":
        return mod.reference_beam_search_np(np.exp(lp), W, 0)
    if name == "reference_log":
        return mod.reference_beam_search_np(lp, W, 0, log_space=True)
    if name == "prefix":
        return mod.prefix_beam_search_np(lp, W, 0)
    return mod.greedy_decode_np(lp, blank_id=0)


@pytest.mark.parametrize("name", ORACLES)
@pytest.mark.parametrize("seed,T,V,W", [(0, 10, 4, 2), (1, 12, 6, 8),
                                        (2, 1, 4, 3), (3, 20, 29, 16)])
def test_oracles_equal_jax(name, seed, T, V, W):
    lp = _lp(np.random.default_rng(seed), T, 1, V)[:, 0]
    assert _call(toracle, name, lp, W) == _call(joracle, name, lp, W)


@pytest.mark.parametrize("algorithm,W,V,T", [
    ("reference", 2, 4, 10), ("reference", 8, 6, 12),
    ("prefix", 2, 4, 10), ("prefix", 8, 6, 12), ("prefix", 16, 29, 20),
    ("reference", 1, 3, 5), ("prefix", 4, 2, 1)])
def test_port_decoder_matches_oracle(algorithm, W, V, T):
    rng = np.random.default_rng(W * 1000 + V * 10 + T)
    B = 3
    lp = _lp(rng, T, B, V)
    res = ctc_beam_search(torch.from_numpy(lp), beam_width=W, blank_id=0,
                          max_len=64, algorithm=algorithm)
    outs = decode_to_lists(res)
    for b in range(B):
        if algorithm == "reference":
            want_ids, want_score = toracle.reference_beam_search_np(
                lp[:, b], W, 0, log_space=True)
        else:
            want_ids, want_score = toracle.prefix_beam_search_np(
                lp[:, b], W, 0)
        ids, score = outs[b]
        assert ids == want_ids, f"batch {b}: {ids} != {want_ids}"
        np.testing.assert_allclose(score, want_score, rtol=1e-3)


def test_port_greedy_matches_oracle():
    lp = _lp(np.random.default_rng(5), 30, 4, 7)
    tokens, lengths = greedy_decode(torch.from_numpy(lp))
    for b in range(4):
        want = toracle.greedy_decode_np(lp[:, b], blank_id=0)
        assert tokens[b, :int(lengths[b])].tolist() == want, b
