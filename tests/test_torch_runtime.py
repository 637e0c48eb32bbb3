"""The port's runtime modules (`gasr_tpu_torch/runtime/`, `utils.py`) and
its small CLIs (`infer.main`, `baseline_compat`) against the JAX
package's counterparts, on the CPU.

The same numpy arrays go to both packages. Exact comparisons hold where
both compute the same values by the same arithmetic (fault injection,
weight import: a transpose and a copy; byte counts); the LSTM forward
from imported weights is held to torch.nn.LSTM at 2e-6, the bound of
the JAX package's own test (tests/test_runtime_validation.py:43):
float32 sums in another order over a few steps.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu.runtime import checkpoint as jckpt
from gasr_tpu.runtime import validation as jval
from gasr_tpu import utils as jutils

from gasr_tpu_torch import utils as tutils
from gasr_tpu_torch.config import Config
from gasr_tpu_torch.models import model_init
from gasr_tpu_torch.ops.lstm import lstm_forward
from gasr_tpu_torch.runtime import (CycleTimer, MemoryMonitor, Timer,
                                    checkpoint as tckpt,
                                    validation as tval)
from gasr_tpu_torch.runtime.checkpoint import flatten_params, params_from_jax
from gasr_tpu_torch.runtime.profiler import Speedometer, profile_fn, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSTM_TOL = 2e-6


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.parametrize("kind", ["nan", "inf", "neg"])
@pytest.mark.parametrize("position", [0, 5, 11])
def test_fault_injection_matches_jax(kind, position):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    tx = torch.from_numpy(x.copy())
    got = tval.inject_fault(tx, kind, position)
    want = np.asarray(jval.inject_fault(jnp.asarray(x), kind, position))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tx, torch.from_numpy(x))     # the input unchanged
    assert issubclass(tval.NumericsError, FloatingPointError)
    if kind == "neg":                               # finite: both pass
        tval.assert_finite(got)
        jval.assert_finite(jnp.asarray(want))
        return
    # nested containers: both raise, naming the tensor
    tree = {"a": [torch.zeros(2), (torch.ones(3), got)],
            "b": torch.arange(3)}
    with pytest.raises(tval.NumericsError, match="logits"):
        tval.assert_finite(tree, "logits")
    with pytest.raises(jval.NumericsError, match="logits"):
        jval.assert_finite({"a": [jnp.zeros(2), (jnp.ones(3), want)],
                            "b": jnp.arange(3)}, "logits")


def test_assert_finite_passes_finite_trees_and_integers():
    tval.assert_finite({"x": [torch.zeros(3), (torch.ones(2, 2),)],
                        "ids": torch.tensor([-1, 7])})
    tval.assert_finite([])


def test_shape_validation():
    with pytest.raises(tval.ShapeError):
        tval.check_features(torch.zeros(2, 3), 4)
    with pytest.raises(tval.ShapeError):
        tval.check_features(torch.zeros(2, 5, 3), 4)
    tval.check_features(torch.zeros(2, 5, 4), 4)
    with pytest.raises(tval.ShapeError):
        tval.check_log_probs(torch.zeros(5, 2, 7), 8)
    tval.check_log_probs(torch.zeros(5, 2, 8), 8)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_import_torch_deepspeech_matches_jax(bidirectional):
    # the reference's DeepSpeech modules (baseline/model.py): mlp123, rnn,
    # mlp56, with [out, in] weights
    torch.manual_seed(3)
    F, L, H, O, layers = 6, 10, 8, 5, 2
    mlp123 = torch.nn.Sequential(torch.nn.Linear(F, L), torch.nn.ReLU(),
                                 torch.nn.Linear(L, L), torch.nn.ReLU(),
                                 torch.nn.Linear(L, H), torch.nn.ReLU())
    rnn = torch.nn.RNN(H, H, num_layers=layers, bidirectional=bidirectional)
    mlp56 = torch.nn.Sequential(torch.nn.Linear(H * (1 + bidirectional), L),
                                torch.nn.ReLU(), torch.nn.Linear(L, O))
    sd = {}
    for name, m in (("mlp123", mlp123), ("rnn", rnn), ("mlp56", mlp56)):
        sd.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    got = flatten_params(tckpt.import_torch_deepspeech(
        sd, num_layers=layers, bidirectional=bidirectional))
    want = flatten_params(jax.device_get(jckpt.import_torch_deepspeech(
        sd, num_layers=layers, bidirectional=bidirectional)))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and it is the port's own layout: the same keys as model_init's
    cfg = Config(device="cpu", input_size=F, n_context=0, linear_size=L,
                 rnn_hidden_size=H, vocab_size=O - 1, rnn_num_layers=layers,
                 bidirectional=bidirectional)
    own = flatten_params(model_init(cfg))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in got.items()}


def test_import_torch_lstm_matches_jax_and_torch():
    torch.manual_seed(1)
    m = torch.nn.LSTM(4, 6, num_layers=2, bidirectional=True)
    x = torch.rand(5, 2, 4)
    with torch.no_grad():
        want, _ = m(x)
    params = tckpt.import_torch_lstm(m.state_dict(), num_layers=2,
                                     bidirectional=True)
    jparams = jax.device_get(jckpt.import_torch_lstm(
        m.state_dict(), num_layers=2, bidirectional=True))
    got_flat, want_flat = flatten_params(params), flatten_params(jparams)
    assert sorted(got_flat) == sorted(want_flat)
    for k in got_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    got = lstm_forward(params, x)
    assert float((got - want).abs().max()) <= LSTM_TOL


def test_tree_size_bytes_matches_jax():
    from gasr_tpu.models.deepspeech import deepspeech_init
    from gasr_tpu.config import Config as JConfig
    cfg = JConfig(input_size=6, n_context=1, linear_size=12,
                  rnn_hidden_size=10, vocab_size=4, bidirectional=True)
    jp = jax.device_get(deepspeech_init(jax.random.PRNGKey(0), cfg))
    tp = params_from_jax(jp)
    assert tutils.tree_size_bytes(tp) == jutils.tree_size_bytes(jp) > 0
    assert tutils.tree_size_bytes({"a": [torch.zeros(3, dtype=torch.int8)],
                                   "b": (torch.zeros(2),)}) == 3 + 8


def test_print_array_info(capsys):
    tutils.print_array_info(torch.tensor([[1.0, -2.0], [3.0, 4.0]]), "w")
    out = capsys.readouterr().out
    assert "[w] shape=(2, 2) dtype=torch.float32 device=cpu" in out
    assert "min=-2 max=4" in out and "finite=True" in out
    tutils.print_array_info(torch.arange(3, dtype=torch.int32), "ids")
    assert "dtype=torch.int32" in capsys.readouterr().out


def test_speedometer():
    s = Speedometer(n_chips=2)
    s.record(batch_size=8, n_frames=100, wall_s=2.0)
    r = s.report()
    assert r["audio_s"] == 8.0 and r["utterances"] == 8.0
    assert abs(r["rtf"] - 4.0) < 1e-9
    assert abs(r["audio_s_per_s_per_chip"] - 2.0) < 1e-9


def test_timer_and_profile_fn_on_cpu():
    t0 = CycleTimer.current_seconds()
    timer = Timer()
    calls = []

    def work(n):
        calls.append(n)
        return {"y": [torch.ones(n)], "n": n}
    out, dt = timer.time("work", work, 3)
    timer.time("work", work, 4)
    assert out["n"] == 3 and dt >= 0 and calls == [3, 4]
    assert timer.counts == {"work": 2}
    assert abs(timer.mean("work") - timer.totals["work"] / 2) < 1e-12
    assert set(timer.report()) == {"work"}
    assert CycleTimer.current_seconds() >= t0
    Timer.sync({"a": (torch.zeros(2), [torch.ones(1)]), "b": 3})  # no-op
    r = profile_fn(work, 2, iters=3, warmup=2)
    assert r["iters"] == 3 and r["mean_s"] >= 0 and len(calls) == 7


def test_memory_monitor_on_the_cpu_makes_no_cuda_call(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA call for a CPU monitor")
    for fn in ("memory_stats", "memory_allocated", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    mon = MemoryMonitor(device="cpu")
    assert mon.device_stats() == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                                  "bytes_limit": 0}
    assert mon.live_device_bytes() == 0 and mon.live_array_table() == []
    assert mon.report() == {"device": mon.device_stats(),
                            "live_device_bytes": 0}
    assert MemoryMonitor.instance() is MemoryMonitor.instance()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_infer_main_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "gasr_tpu_torch.infer", "--device", "cpu",
         "--batch", "2", "--frames", "12", "--beam", "4"], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(re.findall(r"^utt \d: '.*'  score=-?\d+\.\d+$", r.stdout,
                          re.M)) == 2, r.stdout
    assert "transcribe on cpu" in r.stdout


def test_baseline_compat_cli_output_format(tmp_path):
    cfg = [{
        "batch_size": 2, "input_size": 6, "n_context": 1,
        "linear_size": 16, "rnn_hidden_size": 16, "vocab_size": 5,
        "seg_len": 8, "epoch": 2, "device": "cpu", "num_threads": 2,
        "beam_width": 4,
    }]
    p = tmp_path / "config.json"
    p.write_text(json.dumps(cfg))
    r = subprocess.run(
        [sys.executable, "-m", "gasr_tpu_torch.baseline_compat", str(p)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    # exact line formats of baseline/main.py:54-56
    assert re.search(r"^Forward: \d+\.\d+ s$", r.stdout, re.M), r.stdout
    assert re.search(r"^CTC Decode \d+\.\d+ s$", r.stdout, re.M)
    assert re.search(r"^Overall \d+\.\d+ s$", r.stdout, re.M)
    assert "====== config ======" in r.stdout
