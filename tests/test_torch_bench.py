"""The port's bench (`gasr_tpu_torch/bench.py`) and FLOP counts
(`runtime/flops.py`) against the JAX package's `bench.py` and
`gasr_tpu/runtime/flops.py`, on the CPU at tiny shapes.

FLOP counts are analytic functions of the config: equal to JAX's for
every preset, exactly. The bench's outputs are held by their keys and
by the arithmetic that turns times into rows, with the measuring
functions stubbed where a real measurement would take minutes.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from gasr_tpu.config import PRESETS as JPRESETS
from gasr_tpu.runtime import flops as jflops

from gasr_tpu_torch import bench
from gasr_tpu_torch.config import PRESETS, Config
from gasr_tpu_torch.runtime import flops as tflops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JSON line's keys (bench.py:738-744) and detail's
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"ours", "baseline", "config", "rtf_per_chip"}
ROW_KEYS = {"preset", "model", "batch", "T", "beam", "dtype", "forward_ms",
            "forward_ms_range", "decode_ms", "decode_ms_range", "reps",
            "fwd_tflop", "mfu_pct", "audio_s_per_s"}


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _tiny(**kw):
    return Config(device="cpu", batch_size=2, input_size=6, n_context=1,
                  linear_size=16, rnn_hidden_size=16, vocab_size=5,
                  seg_len=8, beam_width=4, **kw)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_flops_match_jax_for_every_preset(name):
    assert sorted(PRESETS) == sorted(JPRESETS)
    cfg, jcfg = PRESETS[name], JPRESETS[name]
    assert tflops.model_fwd_flops(cfg) == jflops.model_fwd_flops(jcfg) > 0
    assert tflops.model_train_flops(cfg) == \
        jflops.model_train_flops(jcfg) == 3 * tflops.model_fwd_flops(cfg)


def test_device_peak_flops(monkeypatch):
    assert tflops.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "NVIDIA H100 80GB HBM3")
    assert tflops.device_peak_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "Some Other Card")
    assert tflops.device_peak_flops() is None


def test_spread_stats_match_jax():
    jb = _jax_bench()
    for samples in ([0.3, 0.1, 0.2], [5.0, 1.0, 4.0, 2.0, 3.0],
                    [1.0, 2.0, 3.0, 4.0, 9.0, 6.0]):
        assert bench._spread_stats(samples) == jb._spread_stats(samples)


def test_measure_ours_returns_jax_keys():
    jb = _jax_bench()
    from gasr_tpu.config import Config as JConfig
    jcfg = JConfig(**{k: v for k, v in dataclasses.asdict(_tiny()).items()
                      if k != "device"})
    want = jb.measure_ours(jcfg, 2, reps=2)
    got = bench.measure_ours(_tiny(), 2, reps=2)
    assert set(got) == set(want)
    assert set(got["forward_stats"]) == set(want["forward_stats"])
    assert got["iters"] == 2 and got["forward_stats"]["reps"] == 2
    assert got["overall_s"] == got["forward_s"] + got["decode_s"] > 0
    nodec = bench.measure_ours(_tiny(), 1, decode=False, reps=1)
    assert nodec["decode_s"] == 0.0 and nodec["decode_stats"] is None


def test_measure_streaming_on_the_cpu():
    st = bench.measure_streaming(_tiny(), chunk_frames=4, iters=1, reps=2)
    assert set(st) == {"median", "min", "max", "iqr", "reps"}
    assert st["reps"] == 2 and 0 < st["min"] <= st["median"] <= st["max"]


def test_degrade_mesh_on_one_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cl = PRESETS["conformer_l"]
    assert cl.mesh_shape == {"data": 2, "model": 4}
    got = bench._degrade_mesh(cl)
    assert got.mesh_shape == {} and got.model == cl.model
    assert cl.mesh_shape == {"data": 2, "model": 4}    # the preset as it was
    ref = PRESETS["reference_large"]
    assert bench._degrade_mesh(ref) is ref
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert bench._degrade_mesh(cl) is cl


def test_report_rows_with_stubbed_measures(monkeypatch, tmp_path, capsys):
    stats = {"median": 0.02, "min": 0.018, "max": 0.025, "iqr": 0.003,
             "reps": 5}
    seen = []

    def fake_ours(cfg, iters, decode=True, adaptive=False, reps=5):
        seen.append((cfg.model, cfg.device, cfg.mesh_shape, iters, adaptive))
        return {"forward_s": 0.02, "decode_s": 0.01, "overall_s": 0.03,
                "forward_stats": stats, "decode_stats": stats,
                "iters": iters}

    monkeypatch.setattr(bench, "measure_ours", fake_ours)
    monkeypatch.setattr(bench, "measure_streaming",
                        lambda cfg, chunk_frames, iters=None: stats)
    monkeypatch.setattr(bench, "BUILD", tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    root_results = open(os.path.join(REPO, "RESULTS.md")).read()
    bench.run_report(argparse.Namespace(iters=None, no_decode=False,
                                        device="cpu"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = line["rows"]
    assert line["metric"] == "report"
    assert [r["preset"] for r in rows] == bench.REPORT_PRESETS + [
        "streaming_Tc20"]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["mfu_pct"] is None                # no peak on the CPU
    for r, name in zip(rows, bench.REPORT_PRESETS):
        cfg = PRESETS[name]
        assert (r["batch"], r["T"], r["beam"]) == (
            cfg.batch_size, cfg.seg_len, cfg.beam_width)
        assert r["forward_ms"] == 20.0 and r["decode_ms"] == 10.0
        assert r["forward_ms_range"] == [18.0, 25.0]
        assert r["fwd_tflop"] == round(tflops.model_fwd_flops(cfg) / 1e12,
                                       3)
        assert r["audio_s_per_s"] == round(
            cfg.batch_size * cfg.seg_len * 0.01 / 0.03, 1)
    stream = rows[-1]
    assert stream["decode_ms"] == 20.0 and stream["audio_s_per_s"] == round(
        256 * 200 * 0.01 / 0.02, 1)
    # every preset on the asked device, conformer_l's mesh degraded
    assert all(dev == "cpu" and iters == 3 and adaptive
               for _, dev, _, iters, adaptive in seen)
    assert all(mesh == {} for _, _, mesh, _, _ in seen)
    table = (tmp_path / "RESULTS.md").read_text()
    assert "Device: cpu" in table and table.count("\n| ") == 7
    assert open(os.path.join(REPO, "RESULTS.md")).read() == root_results


def test_small_cli_prints_the_jax_line():
    # the JAX package's records and baseline caches stay as they were
    def stamps():
        return {p: os.path.exists(os.path.join(REPO, p))
                and os.path.getmtime(os.path.join(REPO, p))
                for p in ("RESULTS.md", "SCALING.json", "bench.py",
                          ".bench_baseline.json",
                          ".bench_baseline.json.small")}
    before = stamps()
    r = subprocess.run(
        [sys.executable, "-m", "gasr_tpu_torch.bench", "--small", "--device",
         "cpu", "--iters", "1", "--baseline-iters", "1"], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == LINE_KEYS
    assert DETAIL_KEYS <= set(out["detail"])
    assert out["unit"] == "audio_s/s" and out["value"] > 0
    assert out["vs_baseline"] > 0 and out["detail"]["device"] == "cpu"
    assert out["detail"]["config"]["batch_size"] == 8
    assert stamps() == before


def test_fault_inject_cli_detects():
    r = subprocess.run(
        [sys.executable, "-m", "gasr_tpu_torch.bench", "--fault-inject",
         "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["fault_injection"] == "detected"
    assert "non-finite" in out["error"]
