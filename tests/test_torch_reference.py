"""PyTorch port's "reference" algorithm, prob domain and sort merge
against the JAX package and the golden fixture, and the decoder's
kernel dispatch against JAX's `_use_pallas`.

Decoders are compared on the SAME input array. Tokens, lengths,
timesteps and overflow must be equal; log-domain scores agree to 1e-5
(torch's and XLA's exp/log1p differ in the last bits on the CPU),
prob-domain scores to a relative 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.infer import Pipeline as JPipeline
from gasr_tpu.models import model_init as j_init

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.ops.cuda import fused_decode
from gasr_tpu_torch.runtime.checkpoint import params_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCORE_TOL = 1e-5


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _lp(seed, T, B, V):
    rng = np.random.default_rng(seed)
    return _log_softmax(rng.standard_normal((T, B, V)).astype(np.float32))


def _assert_same_result(got, want, log_domain=True):
    for f in ("tokens", "lengths", "timesteps", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL,
                               atol=SCORE_TOL if log_domain else 0.0)


@pytest.mark.parametrize("merge_impl", ["auto", "sort"])
def test_reference_matches_golden(merge_impl):
    with np.load(os.path.join(GOLDEN, "reference_small.npz")) as g:
        res = tbs.ctc_beam_search(torch.from_numpy(g["log_probs"]),
                                  beam_width=g["tokens"].shape[1],
                                  max_len=32, algorithm="reference",
                                  merge_impl=merge_impl)
        for f in ("tokens", "lengths", "timesteps"):
            np.testing.assert_array_equal(getattr(res, f).numpy(), g[f], f)
        np.testing.assert_allclose(res.scores.numpy(), g["scores"],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("prob_domain", [False, True])
@pytest.mark.parametrize("W,V,T,B,L", [(2, 4, 10, 3, 16), (4, 5, 7, 3, 16),
                                       (8, 6, 12, 3, 4), (16, 29, 12, 2, 16),
                                       (6, 5, 1, 2, 8)])
def test_reference_matches_jax(W, V, T, B, L, prob_domain):
    lp = _lp(W * 100 + V * 10 + T, T, B, V)
    x = np.exp(lp) if prob_domain else lp
    want = jbs.ctc_beam_search(jnp.asarray(x), beam_width=W, max_len=L,
                               algorithm="reference",
                               prob_domain=prob_domain)
    got = tbs.ctc_beam_search(torch.from_numpy(x), beam_width=W, max_len=L,
                              algorithm="reference", prob_domain=prob_domain)
    _assert_same_result(got, want, log_domain=not prob_domain)
    if L == 4:
        assert bool(got.overflow.any())      # the head-keeping drop runs


@pytest.mark.parametrize("T,B,V,W", [(18, 3, 7, 8), (10, 2, 4, 16),
                                     (25, 2, 29, 12)])
def test_sort_merge_prefix_matches_jax_and_matched(T, B, V, W):
    lp = _lp(T * B + V * W, T, B, V)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=64,
                               merge_impl="sort")
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                              max_len=64, merge_impl="sort")
    _assert_same_result(got, want)
    # the same beams as the port's matched merge (as in the JAX package's
    # test_matched_merge_equals_sort_merge)
    fast = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                               max_len=64, merge_impl="matched")
    np.testing.assert_array_equal(fast.lengths.numpy(), got.lengths.numpy())
    np.testing.assert_allclose(fast.scores.numpy(), got.scores.numpy(),
                               rtol=1e-4, atol=1e-4)
    for b in range(B):
        for w in range(W):
            n = int(fast.lengths[b, w])
            assert fast.tokens[b, w, :n].tolist() == \
                got.tokens[b, w, :n].tolist()


def _jax_use_pallas(merge_impl, algorithm, log_domain, W, V,
                    topk_impl="exact"):
    try:
        return jbs._use_pallas(merge_impl, algorithm, log_domain, W, V,
                               topk_impl, None), None
    except ValueError as e:
        return None, str(e)


def test_kernel_dispatch_matches_jax_use_pallas():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    checked = 0
    for W in (1, 2, 63, 64, 65, 100, 127, 128, 129, 256):
        for V in (1, 2, 46, 47, 127, 128, 129, 255, 256, 257, 500):
            for algorithm, log_domain in (("prefix", True),
                                          ("reference", True),
                                          ("reference", False)):
                for topk_impl in ("exact", "approx"):
                    # JAX "pallas" returns True where its rule holds and
                    # raises elsewhere, with the port's messages (approx:
                    # "exact-top-k only" after the algorithm check)
                    ok, err = _jax_use_pallas("pallas", algorithm,
                                              log_domain, W, V, topk_impl)
                    for dev in (cpu, cuda):
                        if err is None:
                            assert tbs._use_kernels(
                                "pallas", algorithm, log_domain, W, V, dev,
                                topk_impl=topk_impl) == (dev.type == "cuda")
                        else:
                            with pytest.raises(ValueError) as e:
                                tbs._use_kernels("pallas", algorithm,
                                                 log_domain, W, V, dev,
                                                 topk_impl=topk_impl)
                            assert str(e.value) == err
                    # "auto": the kernels on CUDA tensors exactly where JAX
                    # would take them on its accelerator with exact top-k,
                    # for approx too (the one departure: JAX's approx runs
                    # its matched scan, whose selection the kernel's
                    # equals); never on the CPU
                    exact_ok = _jax_use_pallas("pallas", algorithm,
                                               log_domain, W, V)[1] is None
                    assert tbs._use_kernels("auto", algorithm, log_domain, W,
                                            V, cuda, topk_impl=topk_impl) \
                        == exact_ok
                    if topk_impl == "exact":
                        assert exact_ok == (err is None)
                    else:
                        assert err is not None
                    assert not tbs._use_kernels("auto", algorithm,
                                                log_domain, W, V, cpu,
                                                topk_impl=topk_impl)
                    assert fused_decode.in_envelope(W, V) == \
                        (_jax_use_pallas("pallas", "prefix", True, W, V)[1]
                         is None)
                    for impl in ("matched", "sort"):
                        assert not tbs._use_kernels(impl, algorithm,
                                                    log_domain, W, V, cuda,
                                                    topk_impl=topk_impl)
                    checked += 1
    assert checked == 660


@pytest.mark.parametrize("kw", [
    {"prob_domain": True},                                # prefix + prob
    {"algorithm": "reference", "merge_impl": "matched"},
    {"algorithm": "reference", "merge_impl": "pallas"},
    {"algorithm": "reference", "input_lengths": [3]},
    {"algorithm": "beam"},
])
def test_invalid_option_combinations_raise_like_jax(kw):
    lp = np.zeros((4, 1, 3), np.float32)
    jkw = dict(kw)
    tkw = dict(kw)
    if "input_lengths" in kw:
        jkw["input_lengths"] = jnp.asarray(kw["input_lengths"])
        tkw["input_lengths"] = torch.tensor(kw["input_lengths"])
    with pytest.raises(ValueError):
        jbs.ctc_beam_search(jnp.asarray(lp), beam_width=2, **jkw)
    with pytest.raises(ValueError):
        tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=2, **tkw)


def test_pipeline_reference_decoder_matches_jax():
    over = dict(batch_size=3, seg_len=16, linear_size=32, rnn_hidden_size=32,
                vocab_size=9, beam_width=6, decode_max_len=16,
                decoder="reference")
    jc = dataclasses.replace(jcfg.PRESETS["reference_large"], **over)
    tc = dataclasses.replace(tcfg.PRESETS["reference_large"], device="cpu",
                             **over)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(8)))
    x = np.random.default_rng(9).uniform(
        size=(3, 16, tc.feat_size)).astype(np.float32)
    want = JPipeline(jc, params=jp).transcribe(jnp.asarray(x), top=3)
    got = Pipeline(tc, params=params_from_jax(jp)).transcribe(x, top=3)
    assert [[ids for ids, _ in beams] for beams in got] == \
        [[ids for ids, _ in beams] for beams in want]
    np.testing.assert_allclose([[s for _, s in beams] for beams in got],
                               [[s for _, s in beams] for beams in want],
                               rtol=1e-4, atol=1e-4)
