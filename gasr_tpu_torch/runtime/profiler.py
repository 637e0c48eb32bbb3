"""Profiling: the program's own spans, and the operator's trace exporter.

  - `span(name, **attrs)`: a context manager around one layer's work;
    `records()` returns what the current profiler session (or, after it,
    the last one) recorded, without consuming it.
  - They record only while a `torch.profiler` session runs
    (`torch.autograd._profiler_enabled()`). Otherwise a span is one check
    and a shared no-op context: nothing is kept, and no
    `record_function`, CUDA event or synchronisation happens.
  - A span holds its name; its start and end on the clock of the Chrome
    trace that the profiler exports, as ns since the trace's
    `baseTimeNanoseconds` (`Records.base_ns`; the trace's `ts` is that
    over 1000); its id; its parent's id (the innermost span open in its
    thread, or None); the id of its request (the root span's: a span
    opened with no open parent starts a request, and every span of one
    call shares it); and its attrs. The stamps are the host's
    (`time.perf_counter_ns`), put on the trace's wall clock through one
    (`perf_counter_ns`, `time_ns`) anchor a session. A span also opens a
    `torch.profiler.record_function` of its name, so that the exported
    timeline shows it; it records no CUDA event and waits for nothing.
  - Records live in memory for one session. Once the recorder has seen
    the profiler stopped (a span, collection or reading while it is
    off), the next session's first span, collection or reading replaces
    them.
  - The cyclic collector: a `gc.callbacks` entry, installed when this
    module is imported, records each collection as a `gc` span (attrs
    `generation` and `collected`, the objects it freed); with no
    profiler running it returns at once.
  - `trace(log_dir)`: a `torch.profiler` trace of the CPU and, where a
    card is present, the CUDA activity of a code region, written as a
    Chrome trace into `log_dir`; the program's spans are in it as
    `record_function` ranges, and `records()` holds them with their
    parents and attrs.

The recorder is one per process, as the profiler is.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_enabled = torch.autograd._profiler_enabled

# libkineto's ChromeTraceBaseTime: the epoch floored to 7,889,238 s
_TRACE_BASE_S = 7889238


class Span:
    """One recorded span (times in ns since `Records.base_ns`; `end_ns`
    is None while it is open). As a context manager it stamps itself."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "attrs", "_rec", "_range")

    def __init__(self, rec: "_Recorder", name: str, attrs: Dict):
        self.name, self.attrs, self._rec = name, attrs, rec
        self.end_ns = None

    def __enter__(self):
        rec = self._rec
        stack = rec.stack()
        top = stack[-1] if stack else None
        self.id = next(rec.ids)
        self.parent = top.id if top is not None else None
        self.request = top.request if top is not None else self.id
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = rec.now()
        stack.append(self)
        rec.spans.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = self._rec.now()
        self._range.__exit__(*exc)
        self._range = None
        stack = self._rec.stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


class Records(NamedTuple):
    base_ns: int                 # the trace's baseTimeNanoseconds
    spans: List[Span]            # in the order they opened


class _Off:
    """The shared no-op context of a span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.live = False
        self.base_ns = 0
        self.spans: List[Span] = []
        self.ids = itertools.count()
        self._anchor = (0, 0)
        self._local = threading.local()
        self._gc: Optional[Span] = None

    def begin(self) -> None:
        """A new session: a fresh anchor, and the last session's records
        dropped."""
        perf, wall = time.perf_counter_ns(), time.time_ns()
        self.base_ns = wall // 10**9 // _TRACE_BASE_S * _TRACE_BASE_S * 10**9
        self._anchor = (perf, wall - self.base_ns)
        self.spans = []
        self.ids = itertools.count()
        self._gc = None
        self.live = True

    def now(self) -> int:
        perf, at = self._anchor
        return time.perf_counter_ns() - perf + at

    def stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def collection(self, phase: str, info: Dict) -> None:
        if phase == "start":
            s = Span(self, "gc", {"generation": info["generation"]})
            s.__enter__()
            self.stack().pop()          # a collection is no span's parent
            self._gc = s
        elif self._gc is not None:
            s, self._gc = self._gc, None
            s.attrs["collected"] = info["collected"]
            s.__exit__(None, None, None)


_REC = _Recorder()


def _on(enabled=_enabled, rec=_REC) -> bool:
    """Whether a profiler runs; a session begins at the first call that
    finds one running after a call that found none."""
    if not enabled():
        rec.live = False
        return False
    if not rec.live:
        rec.begin()
    return True


def span(name: str, **attrs):
    """A context manager that records `name` while a profiler runs."""
    if not _on():
        return _OFF
    return Span(_REC, name, attrs)


def records() -> Records:
    """The spans of the running or the last session."""
    _on()
    return Records(_REC.base_ns, list(_REC.spans))


def _on_collection(phase, info, on=_on, rec=_REC):
    if on():
        rec.collection(phase, info)


gc.callbacks.append(_on_collection)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region; writes `log_dir/trace.json` (Chrome trace),
    the program's spans included."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
