"""The traced window: `torch.profiler` over it (CPU and CUDA activities),
then its chrome trace reduced to what the per-layer readers and the
result's `breakdown` take.

The trace is written under the temporary directory and deleted once
read. From it:
  - device operations: kernels, copies and fills (categories "kernel",
    "gpu_memcpy", "gpu_memset"), clipped to the window;
  - `busy_s`: the union of their intervals;
  - seconds and launches by operation name;
  - idle gaps: the intervals of the window in which no device operation
    ran, each labelled by the innermost host span (a `record_function`
    of the harness) open when it began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "asrbench.window"
TOP = 10


def profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _events(prof) -> List[dict]:
    path = os.path.join(tempfile.gettempdir(),
                        f"asrbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(spans, starts, t: float) -> str:
    """The innermost span open at t: the latest-starting one that has not
    ended (spans nest, so it is among the last few to start)."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[max(0, i - 8):i]):
        if b > t:
            return name
    return "between spans"


class Trace:
    """What one traced window read: `busy_s`, `window_s`, `ops` (name ->
    [seconds, launches]) and `gaps` ([(label, seconds)], longest first)."""

    def __init__(self, prof, span_names):
        ev = [e for e in _events(prof) if e.get("ph") == "X"]
        win = [e for e in ev if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("the traced window's annotation is missing")
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        self.window_s = (w1 - w0) * 1e-6
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                       if e.get("cat") == "user_annotation"
                       and e.get("name") in span_names)
        starts = [a for a, _, _ in spans]
        iv = []
        self.ops: Dict[str, List[float]] = {}
        for e in ev:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b <= a:
                continue
            iv.append((a, b))
            rec = self.ops.setdefault(e["name"], [0.0, 0])
            rec[0] += (b - a) * 1e-6
            rec[1] += 1
        merged = _union(iv)
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.gaps = sorted(((_label(spans, starts, a), (b - a) * 1e-6)
                            for a, b in gaps), key=lambda g: -g[1])

    def seconds(self, *needles: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        any of `needles`."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.ops.items():
            if any(k in name for k in needles):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[name[:160], sec] for name, (sec, _) in ops],
                "idle_gaps": [[label, sec] for label, sec in self.gaps[:TOP]]}
