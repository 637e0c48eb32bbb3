"""The port's own spans (`gasr_tpu_torch/runtime/profiler.py`) on the CPU:
nothing recorded and no range opened with no profiler running; under a
CPU `torch.profiler`, the span table of the batch, the streaming and the
training paths (names, and nesting read from the spans' intervals),
the spans' stamps on the host's `perf_counter_ns` clock, the collector's
spans, the same lists traced and untraced, and one session's records
kept out of the next."""

import gc
import json
import time
import tracemalloc

import pytest
import torch

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.decoder.beam_search import decode_to_lists
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.runtime import profiler
from gasr_tpu_torch.runtime.profiler import records, span, trace
from gasr_tpu_torch.train import make_optimizer, make_train_step, \
    synthetic_batch

TINY = dict(batch_size=3, input_size=6, n_context=0, linear_size=32,
            rnn_hidden_size=32, vocab_size=10, seg_len=12, beam_width=4,
            decode_max_len=16, device="cpu")


def _cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _pipe():
    return Pipeline(Config(**TINY), generator=torch.Generator()
                    .manual_seed(3))


def _feats(cfg, seed=0, frames=None):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(cfg.batch_size, frames or cfg.seg_len, cfg.feat_size,
                      generator=g)


def _train():
    cfg = Config(**TINY)
    opt = make_optimizer()
    params = Pipeline(cfg, generator=torch.Generator().manual_seed(1)).params
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(2),
                            max_label_len=4)
    return lambda: step(params, state, batch)


def _tree(spans):
    """(name, parent's name) of every span, in the order they opened; a
    span's parent is the innermost span of the thread whose interval
    holds its own (the spans close in the order they opened)."""
    out = []
    for i, s in enumerate(spans):
        parent = next((p for p in reversed(spans[:i])
                       if p.start_ns <= s.start_ns
                       and s.end_ns <= p.end_ns), None)
        out.append((s.name, parent.name if parent is not None else None))
    return out


@pytest.fixture(autouse=True)
def _warm_ranges():
    # the first record_function of a process builds its operator (~1 ms);
    # the reading after it ends that session for the recorder
    with _cpu_profiler():
        with span("warm"):
            pass
    records()


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    before = records()
    pipe, step = _pipe(), _train()
    res = pipe.transcribe(_feats(pipe.config))

    def refuse(*a, **k):
        raise AssertionError("the off path reached the profiler or the card")
    # the recorder's range (torch.optim opens its own, traced or not)
    for mod, fn in ((torch.profiler, "record_function"),
                    (torch.cuda, "synchronize"), (torch.cuda, "Event")):
        monkeypatch.setattr(mod, fn, refuse)
    from gasr_tpu_torch.decoder import ctc_beam_search
    r = ctc_beam_search(pipe.log_probs(_feats(pipe.config)), beam_width=4)
    decode_to_lists(r)
    step()
    gc.collect()
    assert res and span("a") is span("b")
    after = records()
    assert [id(s) for s in after.spans] == [id(s) for s in before.spans]
    tracemalloc.start()
    try:
        for _ in range(1000):
            with span("x"):
                pass
        grown = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert grown < 4096, grown


def _transcribe():
    pipe = _pipe()
    x = _feats(pipe.config)
    return lambda: pipe.transcribe(x)


def _stream():
    pipe = _pipe()
    x = _feats(pipe.config, frames=12)
    return lambda: pipe.transcribe_streaming([x[:, :6], x[:, 6:]])


LISTS = [("decode.lists", None), ("decode.lists.fetch", "decode.lists"),
         ("decode.lists.build", "decode.lists")]
TABLE = {
    "transcribe": (_transcribe, [
        ("transcribe", None), ("model.forward", "transcribe"),
        ("decode.search", "transcribe"), ("decode.lists", "transcribe"),
        ("decode.lists.fetch", "decode.lists"),
        ("decode.lists.build", "decode.lists")]),
    "stream": (_stream, [
        ("stream.chunk", None), ("model.forward", "stream.chunk"),
        ("decode.search", "stream.chunk")] * 2 + LISTS),
    "train": (_train, [
        ("train.step", None), ("train.forward", "train.step"),
        ("model.forward", "train.forward"), ("train.ctc", "train.step"),
        ("ctc.loss", "train.ctc"), ("train.backward", "train.step"),
        ("train.optimizer", "train.step"),
        ("optimizer.clip", "train.optimizer"),
        ("optimizer.step", "train.optimizer")]),
}


@pytest.mark.parametrize("path", sorted(TABLE))
def test_span_table_under_a_cpu_profiler(path):
    make, want = TABLE[path]
    call = make()
    gc.disable()                # a collection would add a `gc` span
    try:
        with _cpu_profiler():
            call()
            call()
    finally:
        gc.enable()
    spans = records().spans
    assert _tree(spans) == want * 2
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns
               for s in spans)


def test_spans_are_stamped_on_the_hosts_perf_counter():
    # the benchmark takes durations from the stamps: each call's spans lie
    # between perf_counter_ns() readings taken just before and after it
    call = _transcribe()
    gc.disable()
    try:
        with _cpu_profiler():
            around = []
            for _ in range(3):
                t0 = time.perf_counter_ns()
                call()
                around.append((t0, time.perf_counter_ns()))
    finally:
        gc.enable()
    spans = records().spans
    assert len(spans) == 3 * 6
    for k, (t0, t1) in enumerate(around):
        mine = spans[6 * k:6 * (k + 1)]
        assert mine[0].name == "transcribe"
        assert all(t0 <= s.start_ns <= s.end_ns <= t1 for s in mine), \
            (t0, t1, [(s.name, s.start_ns, s.end_ns) for s in mine])


def test_a_collection_inside_a_span_is_its_child():
    gc.disable()                # the one collection is the explicit one
    try:
        with _cpu_profiler():
            with span("outer"):
                gc.collect()
    finally:
        gc.enable()
    rec = records()
    outer = next(s for s in rec.spans if s.name == "outer")
    mine = [s for s in rec.spans if s.name == "gc"]
    assert len(mine) == 1 and all(
        outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        for s in mine)
    assert _tree(rec.spans) == [("outer", None), ("gc", "outer")]


def test_the_spans_leave_the_lists_as_they_were():
    pipe = _pipe()
    from gasr_tpu_torch.decoder import ctc_beam_search
    res = ctc_beam_search(pipe.log_probs(_feats(pipe.config)), beam_width=4,
                          max_len=16)
    untraced = decode_to_lists(res, top=2)
    with _cpu_profiler():
        traced = decode_to_lists(res, top=2)
    assert traced == untraced and len(untraced) == TINY["batch_size"]
    assert [s.name for s in records().spans if s.name != "gc"] == \
        [n for n, _ in LISTS]


@pytest.mark.parametrize("between", ["an_untraced_call", "a_reading"])
def test_records_of_a_session_stay_out_of_the_next(between):
    with _cpu_profiler():
        with span("first"):
            pass
    if between == "a_reading":
        assert [s.name for s in records().spans if s.name != "gc"] == \
            ["first"]
    else:
        with span("untraced"):
            pass
    with _cpu_profiler():
        with span("second"):
            pass
    assert [s.name for s in records().spans if s.name != "gc"] == \
        ["second"]


def test_the_exporter_holds_the_programs_spans(tmp_path):
    call = _stream()
    with trace(str(tmp_path / "tr")):
        call()
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stream.chunk", "model.forward", "decode.search",
            "decode.lists", "decode.lists.fetch"} <= names
    assert [s.name for s in profiler.records().spans
            if s.name != "gc"][0] == "stream.chunk"
