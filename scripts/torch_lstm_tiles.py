#!/usr/bin/env python3
"""The streamed LSTM design's warp tiles, on one CUDA card: the plan
`lstm_scan.stream_plan` picks with at most 8 and at most 16 accumulator
tiles (m16 x n8) a warp, each held to the plain version and timed in turns.

    python3 scripts/torch_lstm_tiles.py

Prints ptxas's registers and spills of every `lstm_stream_kernel<MT, OCW>`
instantiation of `gasr_tpu_torch/csrc/lstm_scan.cu` (nvcc with the flags
of `ops/cuda/_lib.py` and `-Xptxas -v`), the card's name and power limit,
then for each bidirectional (T, B, H) the plan under each cap
(`lstm_scan.STREAM_TILES` set to 8, then 16), the max |kernel - plain| of
one call and its time (CUDA events around one call after one warm-up, 5
rounds, the caps alternating which goes first, median). Inputs from a
seeded CUDA generator.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gasr_tpu_torch.ops.cuda import _lib, lstm_scan  # noqa: E402

SHAPES = ((200, 256, 2048), (200, 128, 1536), (4, 1024, 8192),
          (200, 64, 2048), (300, 32, 1024))


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory(dir=_lib.BUILD) as tmp:
        p = subprocess.run(
            [_lib._nvcc(), *_lib._BASE_FLAGS, "-Xptxas", "-v", "-I",
             str(_lib.CSRC), "-o", os.path.join(tmp, "l.so"),
             str(_lib.CSRC / "lstm_scan.cu")], capture_output=True,
            text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    out = (p.stdout + p.stderr).splitlines()
    for i, line in enumerate(out):
        if "lstm_stream_kernel" in line and "Compiling" in line:
            print(line.split("kernel")[-1][:20], out[i + 2].strip(), "|",
                  out[i + 3].strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    _lib.BUILD.mkdir(parents=True, exist_ok=True)
    ptxas_report()
    _lib.build_all(["lstm_scan"])
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    def inputs(T, B, H, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(T, B, 4 * H, device=dev, generator=g) * 0.5,
                (torch.rand(H, 4 * H, device=dev, generator=g) * 2 - 1)
                / H ** 0.5,
                torch.tanh(torch.randn(B, H, device=dev, generator=g)),
                torch.randn(B, H, device=dev, generator=g))

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def use(tiles):
        lstm_scan.STREAM_TILES = tiles
        lstm_scan._designs.clear()

    for T, B, H in SHAPES:
        xf, wf, h0, c0 = inputs(T, B, H, 1)
        xb, wb, _, _ = inputs(T, B, H, 2)

        def call():
            return lstm_scan.lstm_scan_bidir(xf, xb, wf, wb, h0, c0)
        with torch.no_grad():
            want = torch.cat([
                lstm_scan.lstm_scan_plain(xf, wf, h0, c0),
                lstm_scan.lstm_scan_plain(xb, wb, h0, c0, True)], -1)
        res = {}
        for tiles in (8, 16):
            use(tiles)
            plan = lstm_scan._card_design(dev, B, H, 2)[1]
            got = call()
            torch.cuda.synchronize()
            res[tiles] = (plan, float((got - want).abs().max()))
        times = {8: [], 16: []}
        for r in range(5):
            for tiles in ((8, 16) if r % 2 == 0 else (16, 8)):
                use(tiles)
                times[tiles].append(cuda_ms(call))
        for tiles in (8, 16):
            print(f"T={T} B={B} H={H} tiles {tiles}: plan {res[tiles][0]} "
                  f"err {res[tiles][1]:.3g} ms median "
                  f"{np.median(times[tiles]):.4f} "
                  f"{[round(t, 4) for t in times[tiles]]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
