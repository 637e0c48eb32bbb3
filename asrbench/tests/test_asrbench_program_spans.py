"""The per-layer metrics read from the program's own spans
(`asrbench/program_spans.py`): every cell's tiny traced CPU run reports
its metrics of that source, the arithmetic on hand-made records, and
nothing where the program has no recorder (an older `gasr_tpu_torch`)."""

import sys
import types

import pytest

from asrbench import harness, program_spans
from asrbench import trace as tracing
from asrbench.manifest import load_cell, load_manifest
from asrbench.tests._tiny import tiny_cell

MAN = load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
# the metrics whose readers take the program's records
SPAN_METRICS = {"lists_ms.batch", "lists_ms.stream", "gc_ms.stream",
                "ctc_host_ms.train", "optimizer_ms.train"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reports_the_program_span_metrics(cell):
    c = tiny_cell(cell)
    want = SPAN_METRICS & {m["name"] for m in c.per_layer}
    assert want
    r = harness.run(c, 2 ** 31 + 11, 0.3, True, "cpu", log=lambda m: None)
    assert r["correct"], r["checks"]
    for name in want:
        v = r["metrics"][name]["value"]
        assert v is not None and v >= 0.0, (name, v)
        if not name.startswith("gc_ms"):      # a window may hold no collection
            assert v > 0.0, name


class _Span:
    def __init__(self, name, a, b):
        self.name, self.start_ns, self.end_ns = name, a, b


def _records(*spans):
    return types.SimpleNamespace(base_ns=0, spans=list(spans))


def test_host_ms_per_call_sums_the_named_closed_spans(monkeypatch):
    rec = _records(_Span("decode.lists", 0, 2_000_000),
                   _Span("decode.lists.fetch", 0, 1_500_000),
                   _Span("decode.lists", 5_000_000, 6_000_000),
                   _Span("decode.lists", 9_000_000, None),   # still open
                   _Span("gc", 1_000_000, 1_250_000))
    monkeypatch.setattr(program_spans, "records", lambda: rec)
    r = types.SimpleNamespace(calls=2)
    assert program_spans.host_ms_per_call(r, "decode.lists") == 1.5
    assert program_spans.host_ms_per_call(r, "gc") == 0.125
    assert program_spans.host_ms_per_call(r, "train.optimizer") == 0.0
    assert program_spans.host_ms_per_call(
        types.SimpleNamespace(calls=0), "gc") is None


class _Trace:
    def __init__(self, ops):
        self.ops = ops

    seconds = tracing.Trace.seconds


@pytest.mark.parametrize("trace_ops, want", [
    ({}, 0.5),
    ({"Memcpy DtoH (Device -> Pageable)": [0.004, 6],
      "Memcpy HtoD (Pageable -> Device)": [0.1, 2],
      "fused_prefix_decode_kernel": [0.3, 2]}, 2.5),
])
def test_lists_ms_adds_the_build_and_the_pageable_copy(monkeypatch,
                                                       trace_ops, want):
    # the fetch's wait for the decode is not the lists' time
    rec = _records(_Span("decode.lists", 0, 9_000_000),
                   _Span("decode.lists.fetch", 0, 8_000_000),
                   _Span("decode.lists.build", 8_000_000, 8_600_000),
                   _Span("decode.lists.build", 20_000_000, 20_400_000))
    monkeypatch.setattr(program_spans, "records", lambda: rec)
    r = types.SimpleNamespace(calls=2, trace=_Trace(trace_ops))
    assert program_spans.lists_ms_per_call(r) == pytest.approx(want)
    r.trace = None
    assert program_spans.lists_ms_per_call(r) == pytest.approx(0.5)


def test_a_program_without_the_recorder_gives_no_reading(monkeypatch):
    old = types.ModuleType("gasr_tpu_torch.runtime.profiler")
    old.trace = lambda log_dir: None          # a module without the recorder
    monkeypatch.setitem(sys.modules, "gasr_tpu_torch.runtime.profiler", old)
    assert program_spans.records() is None
    for name in sorted(SPAN_METRICS):
        cell = next(w for w in MAN["per_layer"] if w["name"] == name
                    )["workloads"][0]
        read = load_cell(cell).readers[name]
        assert read(types.SimpleNamespace(calls=3, trace=None)) is None
