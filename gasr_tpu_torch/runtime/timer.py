"""Wall-clock timing harness: `CycleTimer` and `Timer`, the port's copy of
`gasr_tpu/runtime/timer.py`.

`CycleTimer.current_seconds` is the reference's CycleTimer::currentSeconds
(cycleTimer.h:71-73), read from the port's native library
(`native.current_seconds`, built with g++ at first use), with
`time.perf_counter` where that library cannot be built. `Timer` splits a
pipeline's time by name as the baseline harness does (baseline/main.py:
38-56): the host clock around the call and a fence on the devices of its
output, so the host work of a call (the decode's lists, its launches) is
counted with the device work it waits for. CUDA events alone would leave
the host work out.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from gasr_tpu_torch.runtime._tree import tensors


class CycleTimer:
    """API twin of CycleTimer::currentSeconds (cycleTimer.h:71-73)."""

    _native = None
    _native_checked = False

    @classmethod
    def current_seconds(cls) -> float:
        if not cls._native_checked:
            cls._native_checked = True
            try:
                from gasr_tpu_torch import native
                native.current_seconds()
                cls._native = native
            except Exception:       # no g++: the host clock of Python
                cls._native = None
        if cls._native is not None:
            return cls._native.current_seconds()
        return time.perf_counter()


class Timer:
    """Accumulating split timer with a device fence (baseline/main.py:
    38-56: forward / decode / overall)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @staticmethod
    def sync(out) -> None:
        """Wait for the devices of every CUDA tensor in `out` (nested
        dicts, lists, tuples, dataclasses); a no-op for CPU tensors."""
        devices = {t.device for t in tensors(out) if t.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)

    def time(self, name: str, fn: Callable, *args, **kwargs):
        t0 = CycleTimer.current_seconds()
        out = fn(*args, **kwargs)
        self.sync(out)
        dt = CycleTimer.current_seconds() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return out, dt

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 0), 1)

    def report(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.totals}
