"""PyTorch port's decoders against the JAX package and the golden
fixtures: greedy, the eager prefix beam search (the plain version of
the CUDA decode and traceback kernels), the stable top-k and the
traceback.

Decoders are compared on the SAME log_probs array. Tokens, lengths,
timesteps and backpointers must be equal; scores agree to 1e-5, since
torch's and XLA's exp/log1p differ in the last bits on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.ops.pallas.fused_decode import traceback_pallas

from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.decoder.greedy import greedy_decode
from gasr_tpu_torch.ops.cuda import fused_decode
from gasr_tpu_torch.ops.cuda.topk import topk, topk_plain

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCORE_TOL = 1e-5


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _lp(seed, T, B, V, kind="random"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    if kind == "quantised":          # many exactly tied scores
        return _log_softmax(np.round(x * 2) / 2)
    if kind == "relu":               # compat_final_relu: exact zeros, raw
        return np.maximum(np.round(x * 2) / 2, 0.0).astype(np.float32)
    return _log_softmax(x)


def _assert_same_result(got, want):
    for f in ("tokens", "lengths", "timesteps", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("name", ["prefix_small", "prefix_wide",
                                  "prefix_lens", "reference_small"])
def test_greedy_matches_golden(name):
    with np.load(os.path.join(GOLDEN, name + ".npz")) as g:
        tokens, lengths = greedy_decode(torch.from_numpy(g["log_probs"]))
        np.testing.assert_array_equal(tokens.numpy(), g["greedy_tokens"])
        np.testing.assert_array_equal(lengths.numpy(), g["greedy_lengths"])


@pytest.mark.parametrize("merge_impl", ["auto", "matched"])
@pytest.mark.parametrize("name,lens", [("prefix_small", None),
                                       ("prefix_wide", None),
                                       ("prefix_lens", [18, 12, 7])])
def test_prefix_decode_matches_golden(name, lens, merge_impl):
    with np.load(os.path.join(GOLDEN, name + ".npz")) as g:
        kw = {} if lens is None else {"input_lengths": torch.tensor(lens)}
        res = tbs.ctc_beam_search(torch.from_numpy(g["log_probs"]),
                                  beam_width=g["tokens"].shape[1],
                                  max_len=32, merge_impl=merge_impl, **kw)
        for f in ("tokens", "lengths", "timesteps"):
            np.testing.assert_array_equal(getattr(res, f).numpy(), g[f], f)
        np.testing.assert_allclose(res.scores.numpy(), g["scores"],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("W,V,T,B,kind", [
    (16, 29, 6, 2, "random"),
    (100, 47, 6, 2, "random"),       # flagship slot/vocab ratio
    (128, 12, 6, 2, "random"),       # W >> V: dead-slot heavy
    (16, 29, 8, 2, "quantised"),
    (100, 47, 6, 2, "relu"),
])
def test_plain_decoder_matches_jax_matched(W, V, T, B, kind):
    lp = _lp(W * 1000 + V, T, B, V, kind)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=16,
                               merge_impl="matched")
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                              max_len=16)
    _assert_same_result(got, want)


@pytest.mark.parametrize("kind", ["random", "relu"])
def test_plain_scan_backpointers_and_hashes_match_jax(kind):
    T, B, W, V = 7, 3, 12, 9
    lp = _lp(11, T, B, V, kind)
    step = jbs._make_frame_step_fast(B, W, V, 0)
    fin_j, ys_j = lax.scan(step, jbs._init_beam(B, W, True),
                           (jnp.asarray(lp), jnp.zeros((T,), bool)))
    fin_t, ys_t = tbs._matched_scan(torch.from_numpy(lp),
                                    tbs._init_beam(B, W, "cpu"), 0)
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_j))
    for f in ("h1", "h2", "hp1", "hp2", "last", "length", "live"):
        np.testing.assert_array_equal(
            getattr(fin_t, f).numpy(),
            np.asarray(getattr(fin_j, f)).astype(np.int64), f)
    for f in ("s1", "s2"):
        np.testing.assert_allclose(getattr(fin_t, f).numpy(),
                                   np.asarray(getattr(fin_j, f)),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


def test_input_lengths_blank_padding_matches_jax():
    T, B, W, V = 9, 3, 8, 7
    lp = _lp(5, T, B, V)
    lens = np.array([9, 5, 2], np.int32)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=8,
                               input_lengths=jnp.asarray(lens))
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                              max_len=8,
                              input_lengths=torch.from_numpy(lens))
    _assert_same_result(got, want)


@pytest.mark.parametrize("kw", [{"algorithm": "reference"},
                                {"prob_domain": True},
                                {"merge_impl": "sort"},
                                {"topk_impl": "approx"},
                                {"lm_bias": torch.zeros(4, 3)}])
def test_unported_decoder_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbs.ctc_beam_search(torch.zeros(2, 1, 3), beam_width=2, **kw)


def test_decode_to_lists():
    lp = _lp(9, 10, 2, 5)
    res = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=4,
                              max_len=8)
    want = jbs.decode_to_lists(jbs.ctc_beam_search(
        jnp.asarray(lp), beam_width=4, max_len=8), top=2)
    got = tbs.decode_to_lists(res, top=2)
    assert [[ids for ids, _ in beams] for beams in got] == \
        [[ids for ids, _ in beams] for beams in want]


def _total_order_cases():
    rng = np.random.default_rng(13)
    yield np.array([[0., -0., 1., -0., 0.]], np.float32), 5
    yield np.round(rng.standard_normal((4, 300)) * 2).astype(np.float32), 37
    z = np.where(rng.random((3, 130)) < 0.5, 0.0, -0.0).astype(np.float32)
    z[:, ::17] = -3.0e38
    yield z, 64
    yield rng.standard_normal((2, 4700)).astype(np.float32), 100


def test_topk_plain_equals_lax_top_k():
    for x, k in _total_order_cases():
        want_v, want_i = lax.top_k(jnp.asarray(x), k)
        got_v, got_i = topk_plain(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                      np.asarray(want_v).view(np.int32))
        # the wrapper takes the plain version for CPU tensors
        assert torch.equal(topk(torch.from_numpy(x), k)[1], got_i)
    # +0.0 ranks above -0.0 (torch.sort / torch.topk would not)
    assert topk_plain(torch.tensor([[0., -0., 1., -0., 0.]]), 5)[1] \
        .tolist() == [[2, 0, 4, 1, 3]]


@pytest.mark.parametrize("L", [4, 12])
def test_traceback_plain_matches_pallas_interpret(L):
    T, B, W, V = 9, 2, 8, 6
    lp = _lp(17, T, B, V)
    fin, ys = tbs._matched_scan(torch.from_numpy(lp),
                                tbs._init_beam(B, W, "cpu"), 0)
    tok, ts, start = fused_decode.traceback_plain(ys, fin.length, L)
    k_tok, k_t, k_start = traceback_pallas(
        jnp.asarray(ys.numpy()), jnp.asarray(fin.length.numpy()), L,
        interpret=True)
    assert int(fin.length.max()) > 4        # L=4 exercises the overflow drop
    np.testing.assert_array_equal(tok.numpy(), np.asarray(k_tok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(k_t))
    np.testing.assert_array_equal(start.numpy(), np.asarray(k_start))
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(fused_decode.traceback(ys, fin.length, L),
                    (tok, ts, start)):
        assert torch.equal(a, b)


def test_pack_state_round_trip_and_envelope():
    B, W, V = 2, 5, 7
    lp = _lp(21, 4, B, V)
    fin, _ = fused_decode.fused_prefix_decode(
        torch.from_numpy(lp), tbs._init_beam(B, W, "cpu"))
    packed = fused_decode.pack_state(fin)
    assert packed.shape == (9, B, W) and packed.dtype == torch.int32
    back = fused_decode.unpack_state(packed)
    for f in fused_decode.FIELDS:
        a, b = getattr(back, f), getattr(fin, f)
        assert torch.equal(a.to(b.dtype), b), f
    assert fused_decode.in_envelope(128, 128)
    assert fused_decode.in_envelope(64, 256)
    assert fused_decode.in_envelope(100, 47)
    assert not fused_decode.in_envelope(129, 12)
    assert not fused_decode.in_envelope(128, 129)
