"""PyTorch port's DeepSpeech forward and end-to-end Pipeline against the
JAX package, with the same params (carried by params_from_jax) and the
same numpy-seeded inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu.infer import Pipeline as JPipeline
from gasr_tpu.models import model_apply as j_apply, model_init as j_init

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.runtime.checkpoint import params_from_jax

# reduced flagship: reference_large's widths cut to H = L = 256, V = 47
REDUCED = dict(batch_size=4, seg_len=20, linear_size=256,
               rnn_hidden_size=256)


def _pair(preset, **over):
    jc = dataclasses.replace(jcfg.PRESETS[preset], **over)
    tc = dataclasses.replace(tcfg.PRESETS[preset], device="cpu", **over)
    return jc, tc


def _feats(cfg, seed):
    return np.random.default_rng(seed).uniform(
        size=(cfg.batch_size, cfg.seg_len, cfg.feat_size)).astype(np.float32)


@pytest.mark.parametrize("preset,over,compat", [
    ("reference_toy", {}, False),
    ("reference_large", REDUCED, False),
    ("reference_large", REDUCED, True),
])
def test_deepspeech_apply_matches_jax(preset, over, compat):
    jc, tc = _pair(preset, **over)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(0)))
    x = _feats(tc, 1)
    want = np.asarray(j_apply(jc, jp, jnp.asarray(x),
                              compat_final_relu=compat))
    got = model_apply(tc, params_from_jax(jp), torch.from_numpy(x),
                      compat_final_relu=compat)
    assert got.shape == (tc.seg_len, tc.batch_size, tc.output_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if compat:                     # exact zeros reach the decoder
        assert (got.numpy() == 0).mean() > 0.1


def test_deepspeech_rnn_impl_pallas_matches_jax_interpret():
    jc, tc = _pair("reference_large", batch_size=8, seg_len=6,
                   linear_size=128, rnn_hidden_size=128)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(2)))
    x = _feats(tc, 3)
    want = np.asarray(j_apply(jc, jp, jnp.asarray(x), rnn_impl="pallas"))
    got = model_apply(tc, params_from_jax(jp), torch.from_numpy(x),
                      rnn_impl="pallas")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_pipeline_transcribe_matches_jax():
    jc, tc = _pair("reference_large", batch_size=3, seg_len=24,
                   linear_size=64, rnn_hidden_size=64, vocab_size=28,
                   beam_width=8, decode_max_len=32)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(4)))
    x = _feats(tc, 5)
    want = JPipeline(jc, params=jp).transcribe(jnp.asarray(x))
    pipe = Pipeline(tc, params=params_from_jax(jp))
    got = pipe.transcribe(x)
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-4, atol=1e-4)
    assert all(len(ids) > 0 for ids, _ in got)
    assert isinstance(pipe.to_text(got[0][0]), str)


def test_pipeline_params_from_seed_on_cpu():
    tc = dataclasses.replace(tcfg.PRESETS["reference_toy"], device="cpu")
    a = Pipeline(tc, generator=torch.Generator().manual_seed(7))
    b = Pipeline(tc, generator=torch.Generator().manual_seed(7))
    x = _feats(tc, 6)
    assert a.transcribe(x) == b.transcribe(x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        a.transcribe_streaming([x])


def test_pipeline_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(tcfg.Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(tcfg.PRESETS["reference_toy"])
    with pytest.raises(RuntimeError, match="CUDA"):
        model_init(tcfg.PRESETS["reference_toy"])


@pytest.mark.parametrize("family", ["bilstm", "deepspeech2", "conformer_s"])
def test_unported_model_families_raise(family):
    cfg = dataclasses.replace(tcfg.PRESETS["reference_toy"], model=family,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_init(cfg)
