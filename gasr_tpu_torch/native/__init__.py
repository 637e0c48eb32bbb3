"""ctypes bindings for the port's native host library (libgasr.so).

The port's own copy of `gasr_tpu/native`: `gasr_native.cpp` is that
package's source, copied verbatim. It holds a monotonic clock, the
audio log-mel front end that `Pipeline.transcribe_audio` runs on the
host (framing, Hann window, radix-2 FFT, mel filterbank, log), and a
multithreaded CPU CTC prefix beam decoder (the stand-in for ctcdecode
that `eval.parity_check` holds the port's decoder against).

The library is built at first use with
    g++ -O3 -fPIC -std=c++17 -pthread -shared
into `gasr_tpu_torch/_build/libgasr.so` (rebuilt when the source is
newer), to a temporary name first and then moved into place, so that
processes building at once never load a half-written file. A failed
build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "gasr_native.cpp"
_SO = Path(__file__).resolve().parents[1] / "_build" / "libgasr.so"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile libgasr.so if it is missing or older than its source."""
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"libgasr.so.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SO.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO


def _get() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gasr_current_seconds.restype = ctypes.c_double
        lib.gasr_logmel.restype = ctypes.c_int
        lib.gasr_logmel.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
        lib.gasr_beam_decode_batch.restype = None
        lib.gasr_beam_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    return _lib


class lib:
    """Namespace mirroring the C API (JAX's `native.lib`)."""

    @staticmethod
    def current_seconds() -> float:
        return _get().gasr_current_seconds()


def current_seconds() -> float:
    return _get().gasr_current_seconds()


def logmel(audio: np.ndarray, sample_rate: int = 16000, n_fft: int = 512,
           hop: int = 160, n_mels: int = 80, fmin: float = 0.0,
           fmax: float = 0.0) -> np.ndarray:
    """audio [n] float32 -> log-mel features [n_frames, n_mels]."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    n = audio.shape[0]
    max_frames = 0 if n < n_fft else 1 + (n - n_fft) // hop
    out = np.empty((max_frames, n_mels), dtype=np.float32)
    got = _get().gasr_logmel(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        sample_rate, n_fft, hop, n_mels, fmin, fmax,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise ValueError("gasr_logmel failed (n_fft must be a power of 2)")
    return out[:got]


def cpu_beam_decode_batch(
    log_probs: np.ndarray, beam_width: int, blank_id: int = 0,
    max_len: int = 256, num_threads: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """log_probs [T, B, V] -> (tokens [B, max_len], lens [B], scores [B]).

    Multithreaded CPU prefix beam search (ctcdecode-equivalent)."""
    log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
    T, B, V = log_probs.shape
    tokens = np.full((B, max_len), -1, dtype=np.int32)
    lens = np.zeros((B,), dtype=np.int32)
    scores = np.zeros((B,), dtype=np.float32)
    _get().gasr_beam_decode_batch(
        log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T, B, V, beam_width, blank_id, max_len, num_threads,
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return tokens, lens, scores
