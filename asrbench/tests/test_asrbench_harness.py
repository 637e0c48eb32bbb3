"""The harness's own logic on the CPU: the manifest and its files, the
rules on names and units, a cell, configuration, mix and metric added as
new files only, the frozen counts, the seeded generators, the import
check, and every cell driven end to end at a tiny size (the benchmark's
command itself refuses to run without a card)."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from asrbench import guard, harness
from asrbench.counts import flops
from asrbench.manifest import ROOT, load_cell, load_manifest
from asrbench.tests._tiny import tiny_cell

from gasr_tpu_torch.config import PRESETS
from gasr_tpu_torch.runtime import flops as program_flops

MAN = load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_files():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["asrbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("asrbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        assert (ROOT / "asrbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (ROOT / "asrbench" / "limits" / f"{w['name']}.json").exists()
        assert len(w["why"]) <= 200
    for m in MAN["per_layer"]:
        assert (ROOT / "asrbench" / "metrics" / f"{m['name']}.py").exists()
    # four cards only where what a cell measures exists only across cards:
    # at most a quarter of the cells, rounded down, and always one
    fours = [w["name"] for w in MAN["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(MAN["workloads"]) // 4), fours


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("config", "traffic"):
                if k in e:
                    assert NAME.match(e[k])
            for k in e.get("reduced", []):
                assert NAME.match(k)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_each_per_layer_metrics_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["layer"])
        for cell in m["workloads"]:
            assert cell in CELLS
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or cell in mv["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        c = load_cell(cell)
        assert {"setup_s"} < {m["name"] for m in c.end_to_end}
        assert c.per_layer


NEW_FAMILY = """from asrbench.reference.deepspeech import (  # noqa: F401
    apply, forward_flops, output_frames, spec)
"""

NEW_LOOP = """from asrbench.loops.transcribe import Load as Transcribe


class Load(Transcribe):
    def end_to_end(self, calls, window_s, latencies):
        return dict(super().end_to_end(calls, window_s, latencies),
                    calls_per_s=calls / window_s)
"""

RUN_NEW_CELL = """
import json, sys
import asrbench
from asrbench import harness
from asrbench.manifest import load_cell
c = load_cell("ds1_small_batch")
r = harness.run(c, 2 ** 31 + 3, 0.3, False, "cpu", log=lambda m: None)
print(json.dumps({"file": asrbench.__file__, "correct": r["correct"],
                  "metrics": sorted(r["metrics"])}))
"""


def test_a_cell_config_family_mix_loop_and_metric_are_added_by_new_files(
        tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "asrbench", root / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "asrbench").rglob("*")
              if p.is_file()}
    bench = root / "asrbench"
    conf = json.loads((bench / "configs/reference_large.json").read_text())
    conf["family"] = "ds1_alias"
    small = dict(linear_size=64, rnn_hidden_size=128)
    conf["model"].update(small)
    conf["program"].update(small, beam_width=8)
    (bench / "configs/ds1_small.json").write_text(json.dumps(conf))
    (bench / "reference/ds1_alias.py").write_text(NEW_FAMILY)
    (bench / "loops/transcribe_counted.py").write_text(NEW_LOOP)
    (bench / "traffic/batch_tiny.json").write_text(json.dumps(
        {"kind": "transcribe_counted", "batch": 8, "frames": 30,
         "pool": 2}))
    (bench / "metrics/calls.batch.py").write_text(
        "def read(r):\n    return float(r.calls)\n")
    (bench / "limits/ds1_small_batch.json").write_text(
        (bench / "limits/ds1_batch.json").read_text())
    man["configs"].append({"name": "ds1_small", "source": "x",
                           "file": "asrbench/configs/ds1_small.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "ds1_small_batch",
                             "config": "ds1_small",
                             "traffic": "batch_tiny", "chips": 1,
                             "why": "x"})
    man["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["ds1_small_batch"]})
    man["per_layer"].append({"name": "calls.batch", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole step",
                             "moves": "calls_per_s",
                             "workloads": ["ds1_small_batch"]})
    man["end_to_end"][1]["workloads"].append("ds1_small_batch")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    c = load_cell("ds1_small_batch", root)
    assert c.config["model"]["rnn_hidden_size"] == 128
    assert c.traffic["kind"] == "transcribe_counted"
    assert "calls.batch" in c.readers
    assert c.readers["calls.batch"](type("R", (), {"calls": 3})) == 3.0
    # the new cell runs from the copy: its family, loop and metric found
    # there by name
    r = subprocess.run([sys.executable, "-c", RUN_NEW_CELL], cwd=root,
                       env=dict(os.environ,
                                PYTHONPATH=f"{root}{os.pathsep}{ROOT}"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(root))
    assert got["correct"]
    assert got["metrics"] == ["audio_s_per_s", "calls_per_s", "setup_s"]
    for p, data in before.items():
        assert p.read_bytes() == data          # no file that was there moved


@pytest.mark.parametrize("lookup,name", [("family", "nonesuch"),
                                         ("family", "decoder"),
                                         ("loop", "nonesuch"),
                                         ("loop", "../run")])
def test_an_unknown_family_or_loop_is_an_error(lookup, name):
    from asrbench import loops, reference
    with pytest.raises(KeyError):
        if lookup == "family":
            reference.family(name)
        else:
            loops.load_class(name)


@pytest.mark.parametrize("preset,config", [("reference_large",
                                            "reference_large"),
                                           ("conformer_l", "conformer_l")])
def test_frozen_counts_equal_the_programs(preset, config):
    conf = json.loads((ROOT / f"asrbench/configs/{config}.json").read_text())
    cfg = PRESETS[preset]
    ours = flops.forward(conf["family"], conf["model"], cfg.batch_size,
                         cfg.seg_len)
    assert ours == program_flops.model_fwd_flops(cfg)
    assert flops.train_step(conf["family"], conf["model"], cfg.batch_size,
                            cfg.seg_len) == \
        program_flops.model_train_flops(cfg)


@pytest.mark.parametrize("config", ["reference_large", "conformer_l"])
def test_config_files_agree_with_the_programs_preset(config):
    conf = json.loads((ROOT / f"asrbench/configs/{config}.json").read_text())
    preset = PRESETS[config]
    for k, v in conf["program"].items():
        # the cells' departures from the presets: one card, the Elman
        # kernel (`departures` in the files)
        if k not in ("mesh_shape", "rnn_impl"):
            assert getattr(preset, k) == v, k
    assert conf["model"]["feat_size"] == preset.feat_size
    assert conf["model"]["vocab_size"] == preset.vocab_size


@pytest.mark.parametrize("cell", CELLS)
def test_generators_are_deterministic_in_the_seed(cell):
    c = tiny_cell(cell)
    seed = 2 ** 31 + 77

    def pool(s):
        _, load = harness.make_load(c, s, "cpu", harness.Spans(False, False))
        return list(load.pool)

    def same(x, y):
        if torch.is_tensor(x):
            return torch.equal(x, y)
        return all(torch.equal(x[k], y[k]) for k in x)
    a, b, other = pool(seed), pool(seed), pool(seed + 1)
    assert all(same(x, y) for x, y in zip(a, b))
    assert not same(a[0], other[0])


def test_the_import_check():
    assert guard.found(["jax.numpy", "gasr_tpu_torch.models", "numpy"]) == \
        ["jax"]
    assert guard.found(["gasr_tpu.config"]) == ["gasr_tpu"]
    assert guard.found(["gasr_tpu_torch", "gasr_tpu_torchx"]) == []
    code = ("import sys, asrbench.run, asrbench.harness, asrbench.judge, "
            "asrbench.calibrate, asrbench.trace; "
            "from asrbench import guard; import gasr_tpu_torch.infer, "
            "gasr_tpu_torch.train; bad = guard.found(); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_command_refuses_to_run_without_a_card():
    r = subprocess.run([sys.executable, "-m", "asrbench.run", "--workload",
                        "ds1_batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "{" not in r.stdout


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_end_to_end_on_the_cpu(cell, traced):
    c = tiny_cell(cell)
    r = harness.run(c, 2 ** 31 + 5, 0.3, traced, "cpu", log=lambda m: None)
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0
    assert r["correct"], r["checks"]
    for v in r["checks"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]
    assert r["device"]["count"] == c.chips
    if traced:
        assert "breakdown" in r and r["device"]["window_s"] > 0
    else:
        names = {m["name"] for m in c.end_to_end}
        assert set(r["metrics"]) == names


@pytest.mark.parametrize("chips", [4, 2])
def test_a_run_on_other_than_its_cells_cards_is_an_error(chips):
    c = tiny_cell("ds1_batch")
    c.chips = chips
    with pytest.raises(RuntimeError, match=f"ran on 1 cards.*asks for "
                                           f"{chips}"):
        harness.run(c, 2 ** 31 + 5, 0.3, False, "cpu", log=lambda m: None)
