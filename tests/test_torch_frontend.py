"""The port's audio front end and evaluation against the JAX package:
the native library (log-mel, CPU beam decoder), `logmel_torch`, `cmvn`,
`add_context`, `Pipeline.transcribe_audio` and `eval.parity_check`.

Inputs are made with numpy from a seed; parameters are carried from JAX
by `params_from_jax`. JAX runs on the CPU (conftest).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu import eval as jeval
from gasr_tpu import native as jnative
from gasr_tpu.data import features as jfeat
from gasr_tpu.infer import Pipeline as JPipeline
from gasr_tpu.models import model_init as j_init

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch import eval as teval
from gasr_tpu_torch import native
from gasr_tpu_torch.data import features as tfeat
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.runtime.checkpoint import params_from_jax

SR, HOP = 16000, 160
# tests/test_audio_anchor.py's tone speech: one sine per symbol, 14
# frames each, plus noise
FREQS = np.array([500.0, 1200.0, 2600.0, 5200.0])
FRAMES_PER_SYMBOL = 14
# Natural-log mel energies of these signals, compared across FFTs (the
# C++ radix-2 loop, pocketfft, XLA's) and across builds of the same C++
# (the JAX package's libgasr.so may be built with -march=native, so with
# fused multiply-adds; the port's without): measured up to 1.2e-3 on
# these inputs, in the quietest bins of 80 mels, where the log magnifies
# a last-bit difference of a small energy; 6e-5 at 13-26 mels.
LOGMEL_TOL = 5e-3


def _synth(rng, label):
    t = np.arange(FRAMES_PER_SYMBOL * HOP, dtype=np.float64) / SR
    w = np.concatenate([np.sin(2 * np.pi * FREQS[s - 1] * t)
                        for s in label]).astype(np.float32)
    return w + rng.standard_normal(w.shape).astype(np.float32) * 0.02


def _waves(seed, n_symbols):
    rng = np.random.default_rng(seed)
    return [_synth(rng, rng.integers(1, len(FREQS) + 1, k))
            for k in n_symbols]


@pytest.mark.parametrize("n_mels", [13, 26, 80])
def test_native_logmel_matches_jax_native_and_logmel_jax(n_mels):
    for a in _waves(n_mels, [1, 3, 4]):
        got = native.logmel(a, sample_rate=SR, n_mels=n_mels)
        want = jnative.logmel(a, sample_rate=SR, n_mels=n_mels)
        assert got.shape == want.shape == (1 + (a.size - 512) // HOP, n_mels)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGMEL_TOL)
        lt = tfeat.logmel_torch(torch.from_numpy(a), n_mels=n_mels)
        lj = np.asarray(jfeat.logmel_jax(jnp.asarray(a), n_mels=n_mels))
        np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=LOGMEL_TOL)
        np.testing.assert_allclose(lt.numpy(), got, rtol=0, atol=LOGMEL_TOL)
    batch = np.stack(_waves(1, [2, 2]))                  # leading dims
    np.testing.assert_array_equal(
        tfeat.logmel_torch(torch.from_numpy(batch), n_mels=n_mels)[1].numpy(),
        tfeat.logmel_torch(torch.from_numpy(batch[1]), n_mels=n_mels).numpy())
    assert native.logmel(np.zeros(100, np.float32)).shape == (0, 80)
    with pytest.raises(ValueError, match="power of 2"):
        native.logmel(np.zeros(1000, np.float32), n_fft=500)


def test_mel_filterbank_is_jax_copy():
    np.testing.assert_array_equal(tfeat._mel_filterbank(SR, 512, 40, 0, 0),
                                  jfeat._mel_filterbank(SR, 512, 40, 0, 0))


def test_native_cpu_beam_decoder_matches_jax_native():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 5, 11))
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    got = native.cpu_beam_decode_batch(lp, beam_width=8, max_len=16)
    want = jnative.cpu_beam_decode_batch(lp, beam_width=8, max_len=16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # same source, possibly other compiler flags: last-bit differences
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-5)
    assert native.current_seconds() > 0


@pytest.mark.parametrize("lengths", [None, [7, 4, 1]])
def test_cmvn_matches_jax(lengths):
    x = np.random.default_rng(4).standard_normal((3, 7, 5)).astype(
        np.float32) * 3 + 1
    want = np.asarray(jfeat.cmvn(jnp.asarray(x), lengths=None if lengths
                                 is None else jnp.asarray(lengths)))
    got = tfeat.cmvn(torch.from_numpy(x), lengths=None if lengths is None
                     else torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if lengths is not None:
        assert (got[1, 4:] == 0).all() and (got[2, 1:] == 0).all()


@pytest.mark.parametrize("n_context", [0, 1, 2])
def test_add_context_matches_jax(n_context):
    x = np.random.default_rng(5).standard_normal((2, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tfeat.add_context(torch.from_numpy(x), n_context).numpy(),
        np.asarray(jfeat.add_context(jnp.asarray(x), n_context)))


# small cuts: 13 or 40 mels, narrow widths, 4 symbols, beam 4
AUDIO_CFGS = {
    "deepspeech": dict(input_size=13, n_context=1, linear_size=48,
                       rnn_hidden_size=48, vocab_size=4, beam_width=4,
                       decode_max_len=16),
    "deepspeech_cmvn": dict(input_size=13, n_context=1, linear_size=48,
                            rnn_hidden_size=48, vocab_size=4, beam_width=4,
                            decode_max_len=16, cmvn=True),
    "bilstm": dict(model="bilstm", input_size=26, n_context=0,
                   rnn_hidden_size=16, rnn_num_layers=2, bidirectional=True,
                   vocab_size=4, beam_width=4, decode_max_len=16),
    # halves T: the decode gets the feature frame counts as lengths, as
    # JAX's transcribe_audio gives them
    "deepspeech2": dict(model="deepspeech2", input_size=40, n_context=0,
                        linear_size=32, rnn_hidden_size=16,
                        rnn_num_layers=1, bidirectional=True, vocab_size=4,
                        beam_width=4, decode_max_len=16, cmvn=True),
}


@pytest.mark.parametrize("name", list(AUDIO_CFGS))
def test_transcribe_audio_matches_jax(name):
    over = AUDIO_CFGS[name]
    jc = jcfg.Config(**over)
    tc = tcfg.Config(device="cpu", **over)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(7)))
    waves = _waves(11, [2, 5, 3])                # 25, 67 and 39 frames
    want = JPipeline(jc, params=jp).transcribe_audio(waves, sample_rate=SR)
    pipe = Pipeline(tc, params=params_from_jax(jp))
    got = pipe.transcribe_audio(waves, sample_rate=SR)
    assert got == want and len(got) == 3
    x, lens = pipe.audio_features(waves, sample_rate=SR)
    assert lens.tolist() == [25, 67, 39]
    assert tuple(x.shape) == (3, 67, tc.feat_size)


def test_parity_check_matches_jax():
    rng = np.random.default_rng(0)
    lp = rng.standard_normal((50, 8, 29)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    got = teval.parity_check(lp, beam_width=16, device="cpu")
    want = jeval.parity_check(lp, beam_width=16)
    assert got["match_rate"] == want["match_rate"] == 1.0
    assert got["mismatches"] == want["mismatches"] == []
    assert teval.main(["--device", "cpu"]) == {"parity_match_rate": 1.0,
                                              "mismatches": 0}
