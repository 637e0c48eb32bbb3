#!/usr/bin/env python3
"""Where the time of the traceback kernel goes, on one CUDA card: its
staging of ys against its walk and its row writes.

    python3 scripts/torch_traceback_probe.py

Builds `gasr_tpu_torch/csrc/fused_decode.cu` (nvcc, the flags of
`ops/cuda/_lib.py`, `-Xptxas -v`) into `gasr_tpu_torch/_build/probe_tb/`
as it is and with the probe macros of `traceback_kernel`:
  - "no_stage": without the cp.async copies of ys into shared memory (the
    walk reads what the buffers hold; time only);
  - "no_walk": without the walk (the chunks are still staged; every row
    is written -1; time only);
  - "no_writes": without the segment and -1 stores (staging and walk
    only; time only);
and swaps each in under `fused_decode.traceback`. At reference_large's
decode shape (T=200, B=256, W=100), conformer_l's (T=300, B=64, W=16)
and the LM edges' (T=200, B=256, W=64), L=256, on the backpointers of a
decode of random log-probs (numpy seed), it prints the plan, the kernel
build's equality with the plain version, each build's time a call (CUDA
events around 20 calls in a row, median of 5 rounds, the builds in
turns: where a call's kernel is shorter than the wrapper's host work,
this is the host's pace) beside the bytes bound (ys read once, tokens
and timesteps written once at 3.35 TB/s), two `fill_(-1)` of the outputs
and a copy of ys (what moving those bytes alone takes), each build's
kernel time on the device (`torch.profiler`, the mean of 20 calls), and
the device activity of one call; then the card's name and power limit.
Imports nothing of JAX. Needs a card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12
VARIANTS = {"kernel": [], "no_stage": ["-DGASR_PROBE_TB_NO_STAGE"],
            "no_walk": ["-DGASR_PROBE_TB_NO_WALK"],
            "no_writes": ["-DGASR_PROBE_TB_NO_WRITES"]}
SHAPES = {"reference_large": (200, 256, 47, 100),
          "conformer_l": (300, 64, 129, 16),
          "LM W=64": (200, 256, 129, 64)}
L = 256


def main() -> int:
    import torch

    from gasr_tpu_torch.decoder.beam_search import _init_beam
    from gasr_tpu_torch.ops.cuda import _lib, fused_decode

    if not torch.cuda.is_available():
        print("torch_traceback_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    out_dir = _lib.BUILD / "probe_tb"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for var, flags in VARIANTS.items():
        so = out_dir / f"libfused_decode_{var}.so"
        cmd = [_lib._nvcc(), *_lib._BASE_FLAGS,
               *_lib._EXTRA_FLAGS["fused_decode"], "-Xptxas", "-v", *flags,
               "-I", str(_lib.CSRC), "-o", str(so),
               str(_lib.CSRC / "fused_decode.cu")]
        procs.append((var, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for var, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"build {var} failed")
        m = re.search(r"traceback_kernel.*?Used (\d+) registers", log,
                      re.S)
        print(f"{var}: traceback_kernel registers "
              f"{m.group(1) if m else '?'}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _lib.SIGNATURES["fused_decode"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[var] = lib

    def use(var):
        _lib._loaded["fused_decode"] = libs[var]

    def cuda_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    rng = np.random.default_rng(5)
    use("kernel")
    for tag, (T, B, V, W) in SHAPES.items():
        z = rng.standard_normal((T, B, V)).astype(np.float32)
        lp = torch.from_numpy(z).to(dev).log_softmax(-1)
        fin, ys = fused_decode.fused_prefix_decode(lp, _init_beam(B, W, dev))
        lens = fin.length.to(torch.int32)
        use("kernel")
        same = all(torch.equal(a, b) for a, b in zip(
            fused_decode.traceback(ys, lens, L),
            fused_decode.traceback_plain(ys, lens, L)))
        if not same:
            raise RuntimeError(f"{tag}: the kernel build differs from the "
                               f"plain version")
        times = {v: [] for v in VARIANTS}
        tok = torch.empty(B, W, L, dtype=torch.int32, device=dev)
        ts = torch.empty_like(tok)
        times["two fill_(-1)"] = []
        times["copy of ys"] = []
        ys_copy = torch.empty_like(ys)
        for _ in range(5):
            for v in VARIANTS:
                use(v)
                times[v].append(cuda_ms(
                    lambda: fused_decode.traceback(ys, lens, L)))
            times["two fill_(-1)"].append(cuda_ms(
                lambda: (tok.fill_(-1), ts.fill_(-1))))
            times["copy of ys"].append(cuda_ms(lambda: ys_copy.copy_(ys)))
        # each build's kernel on the device alone (the profiler's mean)
        dev_us = {}
        for v in VARIANTS:
            use(v)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as pr:
                for _ in range(20):
                    fused_decode.traceback(ys, lens, L)
                torch.cuda.synchronize()
            ks = [e for e in pr.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "traceback_kernel" in e.key]
            dev_us[v] = (ks[0].self_device_time_total / ks[0].count
                         if ks else float("nan"))
        use("kernel")
        nbytes = T * B * W * 4 + 2 * B * W * 4 + 2 * B * W * L * 4
        mean_len = float(lens.float().mean())
        print(f"traceback {tag} T={T} B={B} W={W} L={L} (mean length "
              f"{mean_len:.1f}, plan (TC, G) "
              f"{fused_decode.traceback_plan(W)}): kernel == plain; bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} "
              f"MB); ms a call (CUDA events), medians of 5: " + ", ".join(
                  f"{v} {float(np.median(x)):.4f}" for v, x in times.items())
              + "; kernel on the device (profiler, mean of 20): "
              + ", ".join(f"{v} {us / 1e3:.4f}" for v, us in dev_us.items())
              + f" ms on {card}", flush=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fused_decode.traceback(ys, lens, L)
            torch.cuda.synchronize()
        acts = [e.name for e in prof.events()
                if e.device_type.name == "CUDA"]
        print(f"traceback {tag}: device activity of one call {acts}",
              flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
