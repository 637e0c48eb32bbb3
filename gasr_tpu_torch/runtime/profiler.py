"""Profiling: trace capture and throughput metrics (the port's copy of
`gasr_tpu/runtime/profiler.py`):
  - `trace(log_dir)`: a `torch.profiler` trace of the CPU and, where a
    card is present, the CUDA activity of a code region, written as a
    Chrome trace into `log_dir`;
  - `Speedometer`: accumulates (audio seconds, wall seconds, utterances)
    and reports the real-time factor and audio-seconds/s per card;
  - `profile_fn`: a call's steady-state time, host clock with a device
    fence (`Timer.sync`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

from gasr_tpu_torch.runtime.timer import Timer

FRAME_SHIFT_S = 0.01


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region; writes `log_dir/trace.json` (Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Speedometer:
    """Accumulate decode/forward work and report serving metrics."""

    def __init__(self, frame_shift_s: float = FRAME_SHIFT_S,
                 n_chips: int = 1):
        self.frame_shift_s = frame_shift_s
        self.n_chips = max(n_chips, 1)
        self.audio_s = 0.0
        self.wall_s = 0.0
        self.utterances = 0

    def record(self, batch_size: int, n_frames: int, wall_s: float) -> None:
        self.audio_s += batch_size * n_frames * self.frame_shift_s
        self.wall_s += wall_s
        self.utterances += batch_size

    def report(self) -> Dict[str, float]:
        wall = max(self.wall_s, 1e-9)
        return {
            "audio_s": self.audio_s,
            "wall_s": self.wall_s,
            "utterances": float(self.utterances),
            "rtf": self.audio_s / wall,                      # >1 = faster
            "audio_s_per_s_per_chip": self.audio_s / wall / self.n_chips,
        }


def profile_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1,
               **kwargs) -> Dict[str, float]:
    """Steady-state timing of a callable with a device fence."""
    for _ in range(warmup):
        Timer.sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kwargs)
    Timer.sync(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters": iters}
