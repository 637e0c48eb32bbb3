#!/usr/bin/env python3
"""Where the time of the persistent recurrence kernels goes, on one CUDA
card, at reference_large's Elman shape (the resident design), three
Elman shapes past the resident limit (the streamed design: T=200 at (B,
H) = (256, 4480), (8, 2816), (32, 5120)) and one deepspeech2 LSTM layer.

    python3 scripts/torch_recurrence_probe.py [--quick]

Builds these libraries from `gasr_tpu_torch/csrc/rnn_scan.cu` and
`csrc/lstm_scan.cu` into `gasr_tpu_torch/_build/probe_rec/` (nvcc, the
flags of `ops/cuda/_lib.py`, `-Xptxas -v` for registers and spills):
  - "kernel": as it is;
  - "no_mma": without the products (-DGASR_PROBE_NO_MMA): the step
    barrier, the copies and the epilogue alone (time only);
  - "no_barrier": without the step barrier's arrive and wait
    (-DGASR_PROBE_NO_BARRIER): wrong results, time only;
  - "no_loads": without the copies of h (and, streamed, of W_hh's
    stages) into the ring (-DGASR_PROBE_NO_LOADS): time only;
  - "no_epilogue": without the cluster's sum / the LSTM cell / the
    streamed tile's tanh, and the stores (-DGASR_PROBE_NO_EPILOGUE): time
    only;
  - "no_sum" (rnn_scan): each block adds its own partial tile eight times
    in place of reading its peers' over distributed shared memory
    (-DGASR_PROBE_NO_SUM), the tanh and every store kept: time only;
  - "no_out": without the float32 stores of out, the bf16 h kept
    (-DGASR_PROBE_NO_OUT): time only;
  - "flags": the other step barrier, a release flag a block polled by
    every block, in place of one counter (-DGASR_PROBE_FLAGS): right
    results, checked against the plain version;
  - "bare": without all four: the step loop's skeleton (time only);
  - "clocks": with clock64() counters (-DGASR_PROBE_CLOCKS): thread 0 of
    every block adds each phase's cycles of every step, read back after
    one call: the wait at the step barrier (with the call's prologue:
    W_hh and h0 in, and the first wait), the wait for the staged h (and
    W_hh's stages; streamed: also the step barrier, which the copy warp
    waits at), the products, (rnn_scan) the partial tiles' store and the
    cluster barrier or, streamed, the sum of the K slices' partial tiles,
    the epilogue (the cluster's sum or the LSTM cell, and the stores),
    and each block's span (the clock rate it implies).
Each build is swapped in under the wrappers (`rnn_scan.rnn_scan`,
`lstm_scan.lstm_scan`, `lstm_scan.lstm_scan_bidir`), so the shapes and
plans are the path's. Inputs from a numpy seed: xw [200, 256, 2048], W_hh
[2048, 2048] (reference_large); xw [200, B, H], W_hh [H, H] at the three
streamed shapes; xw [300, 32, 2048] per direction, W_hh [512, 2048]
(deepspeech2). Prints each build's registers, the kernel build's error
against the plain version, the times (CUDA events, median of 5 rounds of
3 calls, the builds in turns) of each build and, beside each Elman call,
of the bf16 `torch.matmul` + `tanh` loop that chip_smoke times as its
library yardstick, the streamed calls' time at T = 1 (the prologue: W_hh
rounded into the scratch, h0, one step), the phase shares, and
`torch.profiler`'s device kernels of one call of each (more than one
kernel, or a cuBLAS or cuDNN kernel among them, fails the probe); then
the card's name and power limit. --quick: the streamed calls alone,
builds kernel, no_mma, no_loads, no_barrier, no_epilogue, no_out and
clocks. Imports nothing
of JAX. Needs a card.
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

VARIANTS = {"kernel": [], "no_mma": ["-DGASR_PROBE_NO_MMA"],
            "no_barrier": ["-DGASR_PROBE_NO_BARRIER"],
            "no_loads": ["-DGASR_PROBE_NO_LOADS"],
            "no_epilogue": ["-DGASR_PROBE_NO_EPILOGUE"],
            "no_sum": ["-DGASR_PROBE_NO_SUM"],
            "no_out": ["-DGASR_PROBE_NO_OUT"],
            "flags": ["-DGASR_PROBE_FLAGS"],
            "bare": ["-DGASR_PROBE_NO_MMA", "-DGASR_PROBE_NO_BARRIER",
                     "-DGASR_PROBE_NO_LOADS", "-DGASR_PROBE_NO_EPILOGUE"],
            "clocks": ["-DGASR_PROBE_CLOCKS"]}
# the builds of each source ("no_sum": the LSTM has no cluster's sum)
BUILDS = {"rnn_scan": list(VARIANTS),
          "lstm_scan": [v for v in VARIANTS if v != "no_sum"]}
PHASES = ("barrier wait (+ prologue)", "h loads", "products",
          "partial store + cluster barrier", "epilogue")
# position of the `clocks` argument in each launch entry
CLOCKS_ARG = {"rnn_scan_launch": 15, "rnn_stream_launch": 22,
              "lstm_scan_launch": 18}
# the streamed design's thread 0 is a consumer: it waits for the step
# barrier only through the stages the copy warp issues after it
PHASES_STREAM = ("prologue", "stage waits (the step barrier's included)",
                 "products", "K-slice sum", "epilogue")
# the streamed design's shapes (T, B, H)
STREAMED = ((200, 256, 4480), (200, 8, 2816), (200, 32, 5120))
QUICK = ("kernel", "no_mma", "no_loads", "no_barrier", "no_epilogue",
         "no_out", "clocks")


def main() -> int:
    import torch

    from gasr_tpu_torch.ops.cuda import _lib, lstm_scan, rnn_scan

    if not torch.cuda.is_available():
        print("torch_recurrence_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    quick = "--quick" in sys.argv[1:]
    builds_of = {name: [v for v in vs if not quick or v in QUICK]
                 for name, vs in BUILDS.items()}
    if quick:
        builds_of["lstm_scan"] = []

    out_dir = _lib.BUILD / "probe_rec"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    procs = []
    for name, builds in builds_of.items():
        for var in builds:
            flags = VARIANTS[var]
            so = out_dir / f"lib{name}_{var}.so"
            cmd = [_lib._nvcc(), *_lib._BASE_FLAGS, "-Xptxas", "-v", *flags,
                   "-I", str(_lib.CSRC), "-o", str(so),
                   str(_lib.CSRC / f"{name}.cu")]
            procs.append((name, var, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failed = []
    for name, var, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            failed.append(f"{name} ({var})")
            continue
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name} {var}: registers {regs}, spill stores {spills}",
              flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _lib.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name, var] = lib
    if failed:
        raise RuntimeError(f"builds failed: {failed}")

    clocks = torch.zeros(8, dtype=torch.int64, device=dev)

    class WithClocks:
        """A library whose launch entry passes the probe's counters."""

        def __init__(self, lib, name):
            self._lib, self._name = lib, name

        def __getattr__(self, attr):
            fn = getattr(self._lib, attr)
            if not attr.endswith("_launch"):
                return fn

            def launch(*args):
                args = list(args)
                args[CLOCKS_ARG[attr]] = _lib.ptr(clocks)
                return fn(*args)
            return launch

    def use(name, var):
        lib = libs[name, var]
        _lib._loaded[name] = WithClocks(lib, name) if var == "clocks" \
            else lib

    def cuda_ms(fn, iters=3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    rng = np.random.default_rng(9)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def elman(T_, B_, H_):
        xw_ = t(rng.standard_normal((T_, B_, H_)) * 0.5)
        w_ = t(rng.uniform(-1, 1, (H_, H_)) / H_ ** 0.5)
        return xw_, w_, torch.zeros(B_, H_, device=dev)

    def library_loop(xw_, w_, h0_):
        w_bf = w_.to(torch.bfloat16)

        def run():
            h = h0_.to(torch.bfloat16)
            for s in range(xw_.shape[0]):
                h = torch.tanh(xw_[s] + torch.matmul(h, w_bf)).to(
                    torch.bfloat16)
        return run

    T, B, H = 200, 256, 2048
    ins = {"rnn_scan": elman(T, B, H)}
    for Ts, Bs, Hs in STREAMED:
        ins[f"rnn_stream_{Bs}x{Hs}"] = elman(Ts, Bs, Hs)
    Tl, Bl, Hl = 300, 32, 512
    xf, wf = t(rng.standard_normal((Tl, Bl, 4 * Hl)) * 0.5), t(
        rng.uniform(-1, 1, (Hl, 4 * Hl)) / Hl ** 0.5)
    xb, wb = t(rng.standard_normal((Tl, Bl, 4 * Hl)) * 0.5), t(
        rng.uniform(-1, 1, (Hl, 4 * Hl)) / Hl ** 0.5)
    z = torch.zeros(Bl, Hl, device=dev)
    calls = {c: ("rnn_scan", (lambda a=a: rnn_scan.rnn_scan(*a)))
             for c, a in ins.items() if not quick or c != "rnn_scan"}
    if not quick:
        calls["lstm_scan"] = ("lstm_scan",
                              lambda: lstm_scan.lstm_scan(xf, wf, z, z))
        calls["lstm_scan_bidir"] = ("lstm_scan",
                                    lambda: lstm_scan.lstm_scan_bidir(
                                        xf, xb, wf, wb, z, z))
    loops = {c: library_loop(*ins[c]) for c in calls if c in ins}

    def errors(var):
        out = {}
        for c, (name, fn) in calls.items():
            if var not in builds_of[name]:
                continue
            use(name, var)
            with torch.no_grad():
                if c in ins:
                    out[c] = float((fn() - rnn_scan.rnn_scan_plain(
                        *ins[c])).abs().max())
                elif c == "lstm_scan":
                    out[c] = float((fn() - lstm_scan.lstm_scan_plain(
                        xf, wf, z, z)).abs().max())
        return out

    e_k = errors("kernel")
    print(f"kernel builds against the plain versions (max |diff|): {e_k}",
          flush=True)
    e_f = errors("flags") if "flags" in builds_of["rnn_scan"] else {}
    print(f"flags builds against the plain versions: {e_f}", flush=True)
    if max([*e_k.values(), *e_f.values()]) > 1e-2:
        raise RuntimeError("a kernel or flags build disagrees with its "
                           "plain version")
    for c in ins:
        if c in calls:
            Tc, Bc, Hc = ins[c][0].shape
            print(f"{c}: design {rnn_scan.design(dev, Bc, Hc)}, plan "
                  f"{rnn_scan._card_design(dev, Bc, Hc)[1]}", flush=True)
    if not quick:
        print(f"lstm_scan plan (Hp, RB, groups) {lstm_scan.plan(Bl, Hl)}",
              flush=True)

    # times: every build in turns, 5 rounds of 3 calls; the library loop
    # beside each Elman call in every round
    times = {(c, v): [] for c, (name, _) in calls.items()
             for v in builds_of[name]}
    for c in loops:
        times[c, "library loop"] = []
    for c, (name, fn) in calls.items():
        for v in builds_of[name]:
            use(name, v)
            fn()
    torch.cuda.synchronize()
    for _ in range(5):
        for c, (name, fn) in calls.items():
            for v in builds_of[name]:
                use(name, v)
                times[c, v].append(cuda_ms(fn))
            if c in loops:
                times[c, "library loop"].append(cuda_ms(loops[c]))
    sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"SM clock after the timing rounds (now, max): {sm_clock.strip()}")
    for (c, v), ts in times.items():
        print(f"{c} {v}: {float(np.median(ts)):.4f} ms (median of 5; "
              f"rounds {[round(x, 4) for x in ts]}) on {card}", flush=True)
    # the streamed calls' prologue: one step
    use("rnn_scan", "kernel")
    for c in ins:
        if c.startswith("rnn_stream") and c in calls:
            xw1, w1, h1 = ins[c]
            one = sorted(cuda_ms(lambda: rnn_scan.rnn_scan(xw1[:1], w1, h1))
                         for _ in range(5))[2]
            print(f"{c} at T = 1 (prologue + one step): {one:.4f} ms",
                  flush=True)

    # phase shares: one call of each with the counters; the cycles a block
    # spends in each phase a step, and the clock the span implies
    def blocks_steps(c):
        if c in ins:
            Tc, Bc, Hc = ins[c][0].shape
            kind, p = rnn_scan._card_design(dev, Bc, Hc)
            if kind == "resident":
                return p[2] * rnn_scan.CLUSTER, Tc, PHASES
            return p[3] * p[5], Tc, PHASES_STREAM
        Hl_p, _, groups = lstm_scan.plan(Bl, Hl)
        return (Hl_p // lstm_scan.UNITS * groups
                * (2 if c.endswith("bidir") else 1), Tl, PHASES)
    for c, (name, fn) in calls.items():
        if "clocks" not in builds_of[name]:
            continue
        use(name, "clocks")
        clocks.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        cyc = clocks.cpu().numpy().astype(np.float64)
        nblk, steps, names = blocks_steps(c)
        span = cyc[len(names)] / nblk
        shares = ", ".join(
            f"{p} {100 * x / cyc[:len(names)].sum():.1f}% "
            f"({x / nblk / steps:.0f} cycles a step)"
            for p, x in zip(names, cyc) if x > 0)
        print(f"{c} phases (thread 0 of each of {nblk} blocks, {steps} "
              f"steps): {shares}; a block's span {span:.0f} cycles in "
              f"{start.elapsed_time(end):.4f} ms: "
              f"{span / start.elapsed_time(end) / 1e6:.3f} GHz", flush=True)

    # the device kernels of one call of each
    use("rnn_scan", "kernel")
    if not quick:
        use("lstm_scan", "kernel")
    ok = True
    for c, (_, fn) in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        lib_k = [k for k in kernels if re.search(
            r"gemm|cublas|cudnn|cutlass|sm90_xmma|ampere|elementwise", k,
            re.I)]
        print(f"{c}: device kernels of one call {kernels}", flush=True)
        if len(kernels) != 1 or lib_k:
            print(f"{c}: expected one device kernel and no library kernel",
                  file=sys.stderr)
            ok = False
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
