"""Time the vocab-sharded decode's kernels on the card in each design.

    python3 scripts/torch_tp_designs.py [--quick]

At reference_large's decode shape (T=200, B=256, V=47, W=100), at B=32
and at conformer_l's (T=300, B=64, V=129, W=16), on random log-probs:
`tp_scan` in the cluster and the push design with n = 1, 2, 4, 8 shards
on the one card (where JAX's envelope admits n), beside
`fused_prefix_decode` (row 2), in turns (CUDA events, best of the turns'
means); the "fused_frame" scan (`tp_frames`) at n = 4 and 1 (host clock,
synchronised) and one `tp_frame` launch's device time (torch.profiler);
each result checked bit-equal to the single-card decode. Prints the
card's name and power limit first. --quick: the flagship shape only,
fewer turns.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gasr_tpu_torch.decoder.beam_search import _init_beam  # noqa: E402
from gasr_tpu_torch.ops.cuda import fused_decode as fd  # noqa: E402


def cuda_ms(fn, iters=3, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def log_probs(seed, T, B, V, dev):
    z = np.random.default_rng(seed).standard_normal((T, B, V))
    z = z - z.max(-1, keepdims=True)
    z = z - np.log(np.exp(z).sum(-1, keepdims=True))
    return torch.from_numpy(z.astype(np.float32)).to(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    shapes = [("reference_large", 200, 256, 47, 100, 0)]
    if not args.quick:
        shapes.append(("conformer_l", 300, 64, 129, 16, 1))
        shapes.append(("reference_large B=32", 200, 32, 47, 100, 2))
    turns = 2 if args.quick else 3
    for name, T, B, V, W, seed in shapes:
        lp = log_probs(seed, T, B, V, dev)
        init = _init_beam(B, W, dev)
        pk = fd.pack_state(init)
        beam, ys1 = fd.fused_prefix_decode(lp, init)
        want = fd.pack_state(beam)
        limit = fd.tp_cluster_limit(dev, W, V)
        runs = {"row 2": lambda: fd.fused_prefix_decode(lp, init)}
        for n in (1, 2, 4, 8):
            for design in ("cluster", "push"):
                if design == "cluster" and n > limit or \
                        not fd.tp_envelope(W, V, n, scan=True):
                    continue
                fins, ys = fd.tp_scan(lp, pk, [dev] * n, design=design)
                torch.cuda.synchronize()
                ok = torch.equal(ys, ys1) and all(
                    torch.equal(fins[s], want) for s in range(n))
                if not ok:
                    print(f"{name} tp_scan {design} n={n}: differs from "
                          f"fused_prefix_decode", flush=True)
                    return 1
                runs[f"tp_scan {design} n={n}"] = (
                    lambda n=n, design=design: fd.tp_scan(
                        lp, pk, [dev] * n, design=design))
        ms = {k: [] for k in runs}
        for _ in range(turns):
            for k in list(runs) + list(reversed(runs)):
                ms[k].append(cuda_ms(runs[k]))
        print(f"{name} (T={T}, B={B}, V={V}, W={W}; cluster limit "
              f"{limit}): " + ", ".join(f"{k} {min(v):.4f} ms"
                                        for k, v in ms.items())
              + " (CUDA events, best of the turns' means of 3); all "
              "bit-equal to fused_prefix_decode", flush=True)
        frames = {}
        for n in [n for n in (4, 1) if fd.tp_envelope(W, V, n, scan=False)]:
            fin, ys = fd.tp_frames(lp, pk, [dev] * n)
            torch.cuda.synchronize()
            if not (torch.equal(ys, ys1) and torch.equal(fin, want)):
                print(f"{name} tp_frames n={n}: differs", flush=True)
                return 1
            frames[n] = min(host_ms(lambda n=n: fd.tp_frames(
                lp, pk, [dev] * n)) for _ in range(turns))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fd.tp_frames(lp, pk, [dev] * 4)
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "tp_frame" in e.key]
        us = sum(e.device_time_total for e in ks) / max(
            1, sum(e.count for e in ks))
        print(f"{name} tp_frames (the 'fused_frame' scan): " + ", ".join(
              f"n={n} {v:.3f} ms" for n, v in frames.items()) + " (host clock, "
              f"synchronised, best of {turns} means of 3); a tp_frame "
              f"launch {us:.2f} us on the device at n=4 (torch.profiler, "
              f"{sum(e.count for e in ks)} launches); bit-equal", flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
