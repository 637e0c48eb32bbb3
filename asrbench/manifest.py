"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration and a traffic mix. Everything of one of
them is a file of its own:
  - `configs/<config>.json` (the manifest's `file`): the model's sizes,
    the program's settings and the reference's precision; its "family"
    names `reference/<family>.py` (the forward, the weights' layout,
    the FLOP count);
  - `traffic/<traffic>.json`: the mix's parameters, read by the loop
    its "kind" names (`loops/<kind>.py`), the one generator of every
    mix of that kind;
  - `limits/<cell>.json`: the limit of each number that decides
    `correct`, with the readings it was set from;
  - `metrics/<metric>.py`: one per-layer metric's reader, a function
    `read(r)` of the run's readings (`harness.Readings`) that returns a
    number or None.
A cell, configuration, model family, mix, kind of loop or metric is
added by new files and new entries in `BENCHMARK.json`, with no edit to
a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Optional[Dict]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, Callable]
    chips: int                     # the cards the cell's ranks hold


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reader(path: Path) -> Callable:
    """The `read` function of a metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        "asrbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              manifest: Optional[Dict] = None) -> Cell:
    man = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"asrbench: no workload named {name!r} "
                         f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    bench = root / "asrbench"
    limits_path = bench / "limits" / f"{name}.json"
    e2e = [m for m in man["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if m["moves"] in e2e_names and reports(m, name)]
    return Cell(
        name=name, config_name=w["config"],
        config=_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else None,
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: reader(bench / "metrics" / f"{m['name']}.py")
                 for m in per_layer},
        chips=w["chips"])
