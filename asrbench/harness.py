"""One run of one cell: set-up, the measured window, the readings, the
comparison with the reference, and the result line.

The traffic file's "kind" names the loop the window drives
(`loops/<kind>.py`, found by that name); every other property of a mix
is a parameter of that loop. The configuration's "family" names its
reference (`reference/<family>.py`), which also gives the layout of the
weights the run draws on the device from the seed (`weights.py`).

A traced run (`--trace 1`) splits each call into spans, CUDA events on
the device and `record_function` ranges on the host, and runs the
profiler over its window (at most the mix's "trace_seconds"); its
per-layer metrics are read from those by the readers in `metrics/`.

A cell's loop may run one process a card (`chips` in `BENCHMARK.json`):
the result's `device.count` is the number of distinct cards its ranks
held, each rank reporting its own current card, and `memory_peak_bytes`
the fullest card's peak; a run whose count is not the cell's `chips` is
an error, not a result. Everything traced (`busy_s`, `window_s`, the
breakdown, the per-layer metrics) is rank 0's, this process's.

Python's cyclic collector stays on in the window, as in a deployment;
set-up's objects are frozen out of its scans first (`gc.freeze`), as a
server does once it has started.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from asrbench import guard, judge, loops
from asrbench import trace as tracing
from asrbench import weights as wmod
from asrbench.common import generator, percentile_ms
from asrbench.manifest import Cell

NOT_FINITE = 1e300           # a compared number that is inf or nan


class Spans:
    """The traced run's spans: `device(name)` times its block by CUDA
    events (device time), `host(name)` by the host clock from a fence at
    its start to its end (the block must end with its result on the
    host); both also open a `record_function` range of that name. Off
    (untraced), they do nothing."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self._events: Dict[str, list] = {}
        self.host_s: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def device(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(name):
            if self.cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                yield
                b.record()
                self._events.setdefault(name, []).append((a, b))
            else:
                t = time.perf_counter()
                yield
                self.host_s.setdefault(name, []).append(
                    time.perf_counter() - t)

    @contextlib.contextmanager
    def host(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(name):
            if self.cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            yield
            self.host_s.setdefault(name, []).append(time.perf_counter() - t)

    def reset(self) -> None:
        self._events.clear()
        self.host_s.clear()

    def range(self, name: str):
        return (torch.profiler.record_function(name) if self.on
                else contextlib.nullcontext())

    def ms(self) -> Dict[str, List[float]]:
        """Every span's durations in ms (after the window's fence)."""
        out = {k: [s * 1e3 for s in v] for k, v in self.host_s.items()}
        for k, evs in self._events.items():
            out[k] = [a.elapsed_time(b) for a, b in evs]
        return out


class Readings:
    """What a per-layer reader reads: the cell, its sizes, the window,
    the spans (ms) and the trace (or None)."""

    def __init__(self, cell: Cell, window_s: float, calls: int,
                 spans: Dict[str, List[float]], trace):
        self.cell, self.window_s, self.calls = cell, window_s, calls
        self.spans, self.trace = spans, trace
        self.model = cell.config["model"]
        self.family = cell.config["family"]
        self.traffic = cell.traffic

    def mean_ms(self, span: str) -> Optional[float]:
        v = self.spans.get(span)
        return statistics.fmean(v) if v else None


def _set_tf32(conf: Dict) -> None:
    tf32 = conf.get("tf32", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32.get("matmul", False))
    torch.backends.cudnn.allow_tf32 = bool(tf32.get("cudnn", False))


def make_load(cell: Cell, seed: int, device: str, spans: Spans):
    """The benchmark's weights from the seed, and the cell's loop on
    them."""
    params = wmod.make(cell.config["family"], cell.config["model"],
                       generator(seed, 1, device), device)
    load = loops.load_class(cell.traffic["kind"])(cell, params, seed,
                                                   device, spans)
    return params, load


def _spread_line(values: List[float]) -> str:
    return (f"mean {statistics.fmean(values) * 1e3:.3f}, "
            + ", ".join(f"p{p} {percentile_ms(values, p):.3f}"
                        for p in (5, 50, 95, 99))
            + f", max {max(values) * 1e3:.3f}")


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        log=print, after: Optional[Callable] = None) -> Dict:
    """One run of `cell`; returns the result line's object. `after(load,
    params)`, where given, is called once the comparison is made (the
    readings of the limits call it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    _set_tf32(cell.config)
    spans = Spans(traced, cuda)
    params, load = make_load(cell, seed, device, spans)
    try:
        return _measure(cell, params, load, spans, seconds, traced, cuda,
                        t_start, log, after)
    finally:
        load.close()


def card(cuda: bool) -> str:
    """This process's device: its current card, or on the CPU the process
    itself."""
    if cuda:
        return f"cuda:{torch.cuda.current_device()}"
    return f"cpu:{os.getpid()}"


def _measure(cell: Cell, params, load, spans: Spans, seconds: float,
             traced: bool, cuda: bool, t_start: float, log,
             after: Optional[Callable]) -> Dict:
    if cuda:
        torch.cuda.synchronize()
    t_made = time.perf_counter()
    load.warm()
    spans.reset()
    if cuda:
        torch.cuda.synchronize()
    log(f"asrbench: set-up: {t_made - t_start:.3f} s to the weights and "
        f"inputs, {time.perf_counter() - t_made:.3f} s of warm-up")
    gc.collect()
    gc.freeze()
    length = seconds
    if traced and "trace_seconds" in cell.traffic:
        length = min(seconds, cell.traffic["trace_seconds"])
    prof = tracing.profiler() if traced else None
    latencies: List[float] = []
    setup_s = time.perf_counter() - t_start
    with (prof if prof is not None else contextlib.nullcontext()):
        with spans.range(tracing.WINDOW):
            t0 = time.perf_counter()
            n = 0
            prev = 0.0
            while True:
                a = time.perf_counter()
                # a loop that judges its last call copies its state aside
                # before each call that may be the last, and the window
                # ends only after such a call
                hooked = load.NEAR_END and a - t0 + 2 * prev >= length
                if hooked:
                    load.near_end(n)
                out = load.call(n)
                b = time.perf_counter()
                prev = b - a
                latencies.append(prev)
                load.capture(n, out)
                n += 1
                # the window also lasts until the sampled calls are done
                if (b - t0 >= length and n >= load.min_calls
                        and (hooked or not load.NEAR_END)):
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    gc.unfreeze()
    # every rank's card and peak: the count is of distinct cards, the peak
    # the fullest card's
    ranks = [(card(cuda), torch.cuda.max_memory_allocated() if cuda else 0)]
    ranks += load.leave()
    count = len({c for c, _ in ranks})
    peak = max(p for _, p in ranks)
    if count != cell.chips:
        raise RuntimeError(f"asrbench: {cell.name} ran on {count} cards "
                           f"({', '.join(c for c, _ in ranks)}); the cell "
                           f"asks for {cell.chips}")
    guard.check("after the window")
    log(f"asrbench: {cell.name}: {n} calls in {window_s:.3f} s "
        f"(set-up {setup_s:.3f} s); host ms a call: "
        f"{_spread_line(latencies)}")
    load.report(latencies, log)

    metrics: Dict[str, Dict] = {}
    extra_device: Dict = {}
    tr = None
    if traced:
        load.after_window(spans)
        tr = tracing.Trace(prof, set(load.SPANS)) if prof else None
        del prof
        r = Readings(cell, window_s, n, spans.ms(), tr)
        for m in cell.per_layer:
            v = cell.readers[m["name"]](r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            extra_device = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        values = dict(load.end_to_end(n, window_s, latencies),
                      setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # the program's state goes; the reference judges what it produced
    load.drop_program()
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    vals, failed = load.numbers(params)
    checks, failed, info = judge.judge(cell, vals, failed)
    log(f"asrbench: reference check {time.perf_counter() - t_ref:.3f} s")
    if after is not None:
        after(load, params)
    attempted = load.attempted(n)
    del load
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    for c in checks.values():               # JSON has no inf or nan
        if not math.isfinite(c["value"]):
            c["value"] = NOT_FINITE
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": count, "memory_peak_bytes": int(peak)}
    dev.update(extra_device)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    if info:
        result["readings"] = info
    result["checks"] = checks
    return result


def print_checks(checks: Dict, file=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=file, flush=True)
