"""Profiling: the program's own spans, and the operator's trace exporter.

  - `span(name)`: a context manager around one layer's work; `records()`
    returns what the current profiler session (or, after it, the last
    one) recorded, without consuming it.
  - They record only while a `torch.profiler` session runs
    (`torch.autograd._profiler_enabled()`). Otherwise a span is one check
    and a shared no-op context: nothing is kept, and no
    `record_function`, CUDA event or synchronisation happens.
  - A span holds its name and its start and end in ns of the host's
    `time.perf_counter_ns()`; a reader takes durations from them. A span
    also opens a `torch.profiler.record_function` of its name, so that
    the exported timeline shows it; it records no CUDA event and waits
    for nothing.
  - Spans of one thread close in the order they opened (a stack a
    thread), so one span's interval holds those opened inside it.
  - Records live in memory for one session. Once the recorder has seen
    the profiler stopped (a span, collection or reading while it is
    off), the next session's first span, collection or reading replaces
    them.
  - The cyclic collector: a `gc.callbacks` entry, installed when this
    module is imported, records each collection as a `gc` span; with no
    profiler running it returns at once.
  - `trace(log_dir)`: a `torch.profiler` trace of the CPU and, where a
    card is present, the CUDA activity of a code region, written as a
    Chrome trace into `log_dir`; the program's spans are in it as
    `record_function` ranges.

The recorder is one per process, as the profiler is.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch

_enabled = torch.autograd._profiler_enabled
_now = time.perf_counter_ns


class Span:
    """One recorded span (`end_ns` is None while it is open). As a
    context manager it stamps itself."""

    __slots__ = ("name", "start_ns", "end_ns", "_rec", "_range")

    def __init__(self, rec: "_Recorder", name: str):
        self.name, self._rec = name, rec
        self.end_ns = None

    def __enter__(self):
        rec = self._rec
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = _now()
        rec.stack().append(self)
        rec.spans.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = _now()
        self._range.__exit__(*exc)
        self._range = None
        stack = self._rec.stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


class Records(NamedTuple):
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
        self.spans: List[Span] = []
        self._local = threading.local()
        self._gc: Optional[Span] = None

    def begin(self) -> None:
        """A new session: the last session's records dropped."""
        self.spans = []
        self._gc = None
        self.live = True

    def stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def collection(self, phase: str) -> None:
        if phase == "start":
            s = Span(self, "gc")
            s.__enter__()
            self.stack().pop()          # a collection is no span's parent
            self._gc = s
        elif self._gc is not None:
            s, self._gc = self._gc, None
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


def span(name: str):
    """A context manager that records `name` while a profiler runs."""
    if not _on():
        return _OFF
    return Span(_REC, name)


def records() -> Records:
    """The spans of the running or the last session."""
    _on()
    return Records(list(_REC.spans))


def _on_collection(phase, info, on=_on, rec=_REC):
    if on():
        rec.collection(phase)


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
