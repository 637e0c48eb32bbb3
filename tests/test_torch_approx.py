"""topk_impl="approx" in the port's decoder against the JAX package's on
the CPU.

JAX's matched step selects with `lax.approx_max_k(cand, W,
recall_target=0.99)` under topk_impl="approx". Off the TPU that is XLA's
sort-and-slice fallback, which at k < n returns `lax.top_k`'s indices bit
for bit, +0.0 above -0.0 included (`tests/test_torch_decode.py::
test_topk_plain_equals_lax_approx_max_k_below_n`); the decoder's k = W is
below n = W*V. So the port's approx decode takes the exact decode's top-W,
on the CPU and in the decode kernel alike.

Decoders are compared on the SAME log_probs array: tokens, lengths and
timesteps equal, scores within 1e-5 (torch's and XLA's exp/log1p differ in
the last bits on the CPU). A fresh beam never reaches a -0.0 score, so the
signed-zero tie is put in by a hand-made beam (`signed_zero_state`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gasr_tpu.decoder import beam_search as jbs

from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.ops.cuda import fused_decode
from chip_smoke import signed_zero_state
from test_torch_cuda import signed_zero_log_probs

SCORE_TOL = 1e-5


def _lp(seed, T, B, V):
    x = np.random.default_rng(seed).standard_normal((T, B, V))
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _assert_same_result(got, want):
    for f in ("tokens", "lengths", "timesteps", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("T,B,V,W", [(20, 4, 12, 8), (40, 3, 29, 16),
                                     (30, 2, 47, 100)])
def test_approx_decode_matches_jax(T, B, V, W):
    lp = _lp(T * V + W, T, B, V)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=32,
                               topk_impl="approx")
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                              max_len=32, topk_impl="approx")
    _assert_same_result(got, want)
    # no -0.0 score arises from a fresh beam: the exact decode is the same
    exact = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                                max_len=32)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(exact, f)), f


def test_approx_decode_with_lm_bias_matches_jax():
    T, B, V, W = 16, 3, 12, 8
    lp = _lp(3, T, B, V)
    lm = (np.random.default_rng(4).standard_normal((V + 1, V)) * 2).astype(
        np.float32)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=32,
                               topk_impl="approx", lm_bias=jnp.asarray(lm))
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                              max_len=32, topk_impl="approx",
                              lm_bias=torch.from_numpy(lm))
    _assert_same_result(got, want)


def test_approx_decode_with_input_lengths_matches_jax():
    T, B, V, W = 14, 3, 12, 8
    lp = _lp(5, T, B, V)
    lens = np.array([14, 9, 2], np.int32)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=16,
                               topk_impl="approx",
                               input_lengths=jnp.asarray(lens))
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                              max_len=16, topk_impl="approx",
                              input_lengths=torch.from_numpy(lens))
    _assert_same_result(got, want)


def test_approx_topk_mode_runs_and_agrees_on_top1():
    """The port of the JAX package's test of the same name: the top-1
    transcripts of the approx decode agree with the exact decode's on at
    least 3 of 4 utterances."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((20, 4, 12)).astype(np.float32)
    lp = torch.from_numpy(x - np.log(np.exp(x).sum(-1, keepdims=True)))
    exact = tbs.ctc_beam_search(lp, beam_width=8, max_len=32)
    approx = tbs.ctc_beam_search(lp, beam_width=8, max_len=32,
                                 topk_impl="approx")
    e = tbs.decode_to_lists(exact)
    a = tbs.decode_to_lists(approx)
    matches = sum(1 for x, y in zip(e, a) if x[0] == y[0])
    assert matches >= 3


def _jax_state(st):
    return jbs._BeamState(
        h1=jnp.asarray(st.h1.numpy().astype(np.uint32)),
        h2=jnp.asarray(st.h2.numpy().astype(np.uint32)),
        hp1=jnp.asarray(st.hp1.numpy().astype(np.uint32)),
        hp2=jnp.asarray(st.hp2.numpy().astype(np.uint32)),
        last=jnp.asarray(st.last.numpy()),
        length=jnp.asarray(st.length.numpy()),
        tb=jnp.asarray(st.tb.numpy()), live=jnp.asarray(st.live.numpy()),
        s1=jnp.asarray(st.s1.numpy()), s2=jnp.asarray(st.s2.numpy()))


@pytest.mark.parametrize("topk_impl", ["exact", "approx"])
@pytest.mark.parametrize("T,B,V,W", [(5, 2, 12, 8), (4, 2, 47, 100),
                                     (3, 2, 256, 64)])
def test_signed_zero_tie_matches_jax(topk_impl, T, B, V, W):
    """From a beam whose live slots carry -0.0, where frame 0's extend
    (slot 0, symbol 1) scores -0.0 beside W or more +0.0 candidates: JAX's
    matched scan in either topk_impl and the port's give the same
    backpointers and state. The -0.0 cell is not a winner of frame 0
    (+0.0 ranks above it); an order that tied -0.0 with +0.0 would take
    it, its index being below W."""
    lp = signed_zero_log_probs(T, B, V, W)
    init = signed_zero_state(B, W, V, "cpu")
    step = jbs._make_frame_step_fast(B, W, V, 0, topk_impl)
    fin_j, ys_j = lax.scan(step, _jax_state(init),
                           (jnp.asarray(lp), jnp.zeros((T,), bool)))
    fin_t, ys_t = tbs._matched_scan(torch.from_numpy(lp), init, 0)
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_j))
    for f in ("h1", "h2", "hp1", "hp2", "last", "length", "live"):
        np.testing.assert_array_equal(
            getattr(fin_t, f).numpy(),
            np.asarray(getattr(fin_j, f)).astype(np.int64), f)
    for f in ("s1", "s2"):
        np.testing.assert_allclose(getattr(fin_t, f).numpy(),
                                   np.asarray(getattr(fin_j, f)),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    parent, char, appended = tbs._unpack_ys(ys_t[0])
    assert not ((parent == 0) & (char == 1) & appended).any()
    assert int(tbs._logaddexp(init.s1, init.s2).view(torch.int32)[0, 0]) \
        == 0                                      # totals are +0.0
    assert init.s1.view(torch.int32).eq(-2 ** 31).all()  # p_blank -0.0


def test_approx_auto_on_cpu_runs_the_eager_matched_scan(monkeypatch):
    """"auto" with approx on CPU tensors: T frames of the eager matched
    step, no launch."""
    seen = []
    step = tbs._frame_step

    def counting(state, f, blank_id, lm_q=None):
        seen.append(f.shape)
        return step(state, f, blank_id, lm_q)

    monkeypatch.setattr(tbs, "_frame_step", counting)
    n0 = fused_decode.decode_launches
    tbs.ctc_beam_search(torch.from_numpy(_lp(1, 6, 2, 9)), beam_width=4,
                        topk_impl="approx")
    assert seen == [(2, 9)] * 6
    assert fused_decode.decode_launches == n0
    assert not tbs._use_kernels("auto", "prefix", True, 4, 9,
                                torch.device("cpu"), topk_impl="approx")
