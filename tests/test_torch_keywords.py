"""The port's functions take the JAX package's keyword arguments: each
param init's `dtype` (drawn in that dtype, checked for float32 and
bfloat16), `train_loop(mesh=None)` and `evaluate_librispeech(
sample_rate=16000)`, which JAX accepts and does not use. The framework's
own renames stay (`key` -> `generator`)."""

import math

import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu import eval as jeval

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch import eval as teval
from gasr_tpu_torch import train as ttrain
from gasr_tpu_torch.models.bilstm import bilstm_init
from gasr_tpu_torch.models.conformer import conformer_init
from gasr_tpu_torch.models.deepspeech import deepspeech_init
from gasr_tpu_torch.models.deepspeech2 import ds2_init
from gasr_tpu_torch.ops.attention import mhsa_rel_init
from gasr_tpu_torch.ops.conv import conv2d_init
from gasr_tpu_torch.ops.linear import linear_init
from gasr_tpu_torch.ops.lstm import lstm_cell_init, lstm_init
from gasr_tpu_torch.ops.rnn import rnn_cell_init, rnn_init
from gasr_tpu_torch.runtime._tree import tensors as tree_leaves


def _cfg(model, **kw):
    return tcfg.Config(model=model, batch_size=2, input_size=8, n_context=0,
                       linear_size=16, rnn_hidden_size=16, vocab_size=9,
                       seg_len=8, num_blocks=1, device="cpu", **kw)


# (name, call with JAX's keyword names, the leaves JAX draws in dtype)
_INITS = [
    ("linear_init", lambda g, dt: linear_init(g, in_dim=4, out_dim=3,
                                              dtype=dt), None),
    ("rnn_cell_init", lambda g, dt: rnn_cell_init(
        g, input_size=4, hidden_size=3, dtype=dt), None),
    ("rnn_init", lambda g, dt: rnn_init(
        g, input_size=4, hidden_size=3, num_layers=2, bidirectional=True,
        dtype=dt), None),
    ("lstm_cell_init", lambda g, dt: lstm_cell_init(
        g, input_size=4, hidden_size=3, dtype=dt), None),
    ("lstm_init", lambda g, dt: lstm_init(
        g, input_size=4, hidden_size=3, num_layers=2, bidirectional=True,
        dtype=dt), None),
    ("conv2d_init", lambda g, dt: conv2d_init(
        g, in_ch=2, out_ch=3, kernel=(3, 3), dtype=dt), None),
    ("mhsa_rel_init", lambda g, dt: mhsa_rel_init(
        g, d_model=8, num_heads=2, dtype=dt), None),
    ("deepspeech_init", lambda g, dt: deepspeech_init(
        g, config=_cfg("deepspeech"), dtype=dt), None),
    ("bilstm_init", lambda g, dt: bilstm_init(
        g, config=_cfg("bilstm", bidirectional=True), dtype=dt), None),
    ("ds2_init", lambda g, dt: ds2_init(
        g, config=_cfg("deepspeech2", bidirectional=True), dtype=dt), None),
    # JAX's conformer_init passes dtype to the stem and the projection
    # alone; its blocks stay float32
    ("conformer_init", lambda g, dt: conformer_init(
        g, config=_cfg("conformer_s"), dtype=dt),
     ("sub1", "sub2", "sub_proj", "proj")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name,init,in_dtype", _INITS,
                         ids=[i[0] for i in _INITS])
def test_param_inits_take_jax_dtype_keyword(name, init, in_dtype, dtype):
    params = init(torch.Generator().manual_seed(0), dtype)
    parts = [params] if in_dtype is None else \
        [params[k] for k in in_dtype]
    leaves = [t for p in parts for t in tree_leaves(p)]
    assert leaves and all(t.dtype == dtype for t in leaves), name
    assert all(bool(torch.isfinite(t.float()).all()) for t in leaves)
    if in_dtype is not None:                   # the rest stays float32
        rest = [t for k, v in params.items() if k not in in_dtype
                for t in tree_leaves(v)]
        assert rest and all(t.dtype == torch.float32 for t in rest)


def test_train_loop_takes_mesh_keyword():
    cfg = tcfg.Config(batch_size=2, input_size=6, n_context=0,
                      linear_size=16, rnn_hidden_size=16, vocab_size=10,
                      seg_len=12, device="cpu")
    p1, l1 = ttrain.train_loop(cfg, num_steps=2, checkpoint_path=None,
                               resume=False, log_every=1, mesh=None)
    p2, l2 = ttrain.train_loop(cfg, num_steps=2, log_every=1)
    assert l1 == l2 and all(np.isfinite(l1))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_evaluate_librispeech_takes_sample_rate_keyword(tmp_path):
    (tmp_path / "test-clean").mkdir()          # a split with no utterance
    kw = dict(root=str(tmp_path), split="test-clean", limit=50,
              sample_rate=16000)
    got = teval.evaluate_librispeech(tcfg.Config(device="cpu"), None, **kw)
    want = jeval.evaluate_librispeech(jcfg.Config(), None, **kw)
    assert got["n"] == want["n"] == 0
    assert math.isnan(got["wer"]) and math.isnan(want["wer"])
