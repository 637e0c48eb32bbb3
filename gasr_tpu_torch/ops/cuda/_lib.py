"""Build and load the hand-written CUDA kernels (`gasr_tpu_torch/csrc`).

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, `_build/lib<name>.so` inside
the package, and loaded with `ctypes`. A library is rebuilt when its
source or any `csrc/*.cuh` header is newer than it. `build_all` starts
one `nvcc` per stale source, all at once.

Pointers and the current stream go across as `c_void_p`, sizes as
`c_int`, strides as `c_longlong`. Every C entry returns
`cudaGetLastError()` after its launches; `check` raises when that is not
0 (a refused launch never runs, and `torch.cuda.synchronize()` would not
report it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# fused_decode, decode_tp and bias_act are held bit-equal to their plain
# versions, ctc_loss and add_ln compute their plain versions' expressions
# in order, and pos_conv's epilogue is bias_act's:
# -fmad=false stops nvcc from contracting a product into a following sum
# across what are separate tensor ops in PyTorch. (topk and exchange_probe
# do no float arithmetic.)
_EXTRA_FLAGS = {"fused_decode": ["-fmad=false"], "decode_tp": ["-fmad=false"],
                "ctc_loss": ["-fmad=false"], "add_ln": ["-fmad=false"],
                "bias_act": ["-fmad=false"], "pos_conv": ["-fmad=false"]}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures (argtypes) of each library's entry points
SIGNATURES: Dict[str, Dict[str, List]] = {
    "flash_mhsa": {"flash_mhsa_rel_launch": [_P] * 8 + [_I] * 4 + [_L] * 9
                   + [_F, _I, _I, _P],
                   "flash_mhsa_launch": [_P] * 5 + [_I] * 4 + [_L] * 9
                   + [_F, _I, _I, _P]},
    "stem": {
        "stem_conv_launch": [_P, _L, _L, _L] + [_P] * 5 + [_I] * 5 + [_P],
        "stem_proj_launch": [_P] * 3 + [_I] * 4 + [_P, _P],
        "stem_conv_smem": [_I],
        "stem_window_max": [],
    },
    "topk": {"topk_launch": [_P, _I, _I, _I, _P, _P, _P]},
    "fused_decode": {
        "fused_prefix_decode_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P,
                                       _P, _P],
        "fused_prefix_decode_info": [_I, _I, _I, _IP, _IP, _IP],
        "traceback_launch": [_P, _P] + [_I] * 6 + [_P] * 4,
        "traceback_smem": [_I] * 5,
        "traceback_overlay_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                     _P, _P, _P],
    },
    "decode_tp": {
        "tp_frame_launch": [_P, _L, _I] + [_P] * 5 + [_I, _P, _P, _P]
        + [_I] * 4 + [_P] + [_I] * 5 + [_P],
        "tp_scan_cluster_limit": [_I, _I, _IP],
        "tp_scan_cluster_launch": [_P, _P] + [_I] * 6 + [_P] * 3,
        "tp_scan_push_capacity": [_I, _I, _I, _IP],
        "tp_scan_push_launch": [_P, _P] + [_I] * 6 + [_P, _I, _I]
        + [_P] * 4,
        "enable_peer_access": [_I],
    },
    "exchange_probe": {
        "toy_cluster_limit": [_IP],
        "toy_cluster_launch": [_P, _I, _I, _I, _P, _P],
        "toy_push_capacity": [_I, _IP],
        "toy_push_launch": [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P],
    },
    "rnn_scan": {"rnn_scan_launch": [_P] * 3 + [_I] * 9 + [_P] * 5,
                 "rnn_scan_smem": [_I] * 3,
                 "rnn_scan_max_clusters": [_I] * 3,
                 "rnn_stream_launch": [_P] * 3 + [_I] * 15 + [_P] * 6,
                 "rnn_stream_smem": [_I] * 4,
                 "rnn_stream_max_blocks": [_I]},
    "ctc_loss": {"ctc_forward_launch": [_P, _L, _L, _L] + [_P] * 3
                 + [_I] * 5 + [_P] * 3,
                 "ctc_backward_launch": [_P] * 4 + [_P, _L] + [_I] * 5
                 + [_P, _P, _L, _L, _L, _P]},
    "add_ln": {"add_ln_launch": [_P, _L, _L, _P, _L, _L, _I, _F] + [_P] * 4
               + [_I] * 4 + [_P]},
    "bias_act": {"bias_act_launch": [_P, _P, _P, _L, _I, _I, _I, _P]},
    "pos_conv": {"pos_conv_launch": [_P] * 4 + [_I] * 7 + [_P]},
    "lstm_scan": {"lstm_scan_launch": [_P] * 6 + [_I] * 8 + [_P] * 6,
                  "lstm_scan_smem": [_I],
                  "lstm_scan_max_blocks": [_I],
                  "lstm_stream_launch": [_P] * 6 + [_I] * 17 + [_P] * 7,
                  "lstm_stream_smem": [_I] * 5,
                  "lstm_stream_max_blocks": [_I]},
}

_loaded: Dict[str, ctypes.CDLL] = {}


def scan_supported(B: int, H: int) -> bool:
    """The JAX package's shape rule for its recurrence kernels
    (`gasr_tpu/ops/pallas/rnn_scan.py:96-115`, `lstm_scan.py:83-97`):
    `rnn_forward` / `lstm_forward` with impl="pallas" take the rnn_scan /
    lstm_scan kernel at these (batch, hidden) shapes and the float32 loop
    at any other. Both wrappers take every H: past their resident limits
    (`rnn_scan.max_hidden`, `lstm_scan.max_hidden`) their streamed
    designs."""
    return H % 128 == 0 and B % 8 == 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels are built from gasr_tpu_torch/csrc at first "
                       "use")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all(names=None) -> float:
    """Compile every stale kernel library in parallel; returns seconds."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *_BASE_FLAGS, *_EXTRA_FLAGS.get(name, []), "-I",
               str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if missing or stale."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
