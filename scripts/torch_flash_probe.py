#!/usr/bin/env python3
"""Where the time of the rel-pos flash attention kernel goes, on one CUDA
card, at conformer_l's shape.

    python3 scripts/torch_flash_probe.py

Builds three libraries from `gasr_tpu_torch/csrc/flash_mhsa.cu` into
`gasr_tpu_torch/_build/probe/` (nvcc, the flags of `ops/cuda/_lib.py`,
`-Xptxas -v` for registers and spills):
  - the kernel as it is;
  - the kernel with `clock64()` counters around the phases of its
    key-tile loop (prologue, wait for the tile's copies and the barrier,
    the band product, qu . K^T, the skew with the mask and the row maxima,
    the softmax, p~ . V, the end barrier with the next tile's copies),
    summed over the warps and read back after one launch;
  - the kernel without the copies of the key-tile loop, for its time only
    (its results are wrong): the cost of staging K, V and R each tile.
Inputs: B=64, H=8, T=300, dh=64, bf16, q, k and v as `mhsa_rel` passes
them (strided views of one [T, B, 3D] qkv product), full lengths, from a
numpy seed. Prints each build's registers, the kernel's error against
`flash_mhsa_rel_plain`, both times (CUDA events, 50 launches after a
warm-up, in turns: kernel, no copies, no copies, kernel), the phase
table, and the card's name and power limit. Imports nothing of JAX.
Needs a card.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ["prologue", "wait + barrier", "band", "qu . K^T",
          "skew + mask + max", "softmax", "p~ . V", "barrier + copies"]


def _variants(src: str) -> dict:
    """The kernel's source, with phase counters, and without the loop's
    copies (edits anchored on lines of the source; an anchor that is gone
    raises)."""
    def once(s, old, new):
        if s.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once: {old!r}")
        return s.replace(old, new)

    loop = "  for (int kt = 0; kt < nk; ++kt) {\n"
    top = ("    wait_group<1>();            // group kt; group kt + 1 may "
           "be in flight\n    __syncthreads();\n")
    issue = "    if (kt + 2 < nk) issue(kt + 2);\n"
    end = "    commit();\n  }\n"
    p = src.replace("namespace {\n",
                    "__device__ unsigned long long g_prof[16];\n"
                    "namespace {\n", 1)
    p = once(p, "  extern __shared__ __align__(128) unsigned char smem[];\n",
             "  extern __shared__ __align__(128) unsigned char smem[];\n"
             "  const long long t_start = clock64();\n")
    p = once(p, loop,
             "  long long tc = clock64();\n"
             "  unsigned long long ph[8] = {(unsigned long long)(tc - "
             "t_start)};\n"
             "#define TICK(i) { long long t_ = clock64(); ph[i] += t_ - tc; "
             "tc = t_; }\n" + loop)
    p = once(p, top, top + "    TICK(1)\n")
    for i, anchor in ((2, "    // qu . K^T\n"),
                      (3, "    // + bd by the skew"),
                      (4, "    // p~ = exp2(x - m)"),
                      (5, "    const bf16* vt = v_s(kt);\n"),
                      (6, "    __syncthreads();              // every warp "
                          "is done")):
        p = once(p, anchor, f"    TICK({i})\n" + anchor)
    p = once(p, issue + end, issue + "    commit();\n    TICK(7)\n  }\n")
    p = once(p, "  // out = o / l",
             "  if (lane == 0) {\n"
             "    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], ph[i]);\n"
             "    atomicAdd(&g_prof[8], 1ull);\n"
             "  }\n  // out = o / l")
    p += ('\nextern "C" int prof_read(unsigned long long* h) {\n'
          "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n"
          "}\n"
          'extern "C" int prof_zero() {\n'
          "  unsigned long long z[16] = {};\n"
          "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
          "}\n")
    return {"kernel": src, "phases": p, "no_copies": once(src, issue, "")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    from gasr_tpu_torch.ops.cuda import _lib, flash_mhsa as fm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = _lib.BUILD / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = _variants((_lib.CSRC / "flash_mhsa.cu").read_text())
    procs = []
    for name, text in srcs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs.append((name, subprocess.Popen(
            [_lib._nvcc(), *_lib._BASE_FLAGS, "-Xptxas", "-v", "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            return 1
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{name}: registers by head-width instantiation {regs}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.flash_mhsa_rel_launch.argtypes = \
            _lib.SIGNATURES["flash_mhsa"]["flash_mhsa_rel_launch"]
        libs[name] = lib

    dev = torch.device("cuda")
    bf = torch.bfloat16
    B, H, T, dh = 64, 8, 300, 64
    D = H * dh
    rng = np.random.default_rng(0)

    def t(*shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc).astype(
            np.float32)).to(dev)
    qkv = t(T, B, 3 * D).to(bf)
    q, k, v = (qkv[:, :, i * D:(i + 1) * D].reshape(T, B, H, dh)
               .permute(1, 2, 0, 3) for i in range(3))
    wr, u, vb = t(D, D, sc=D ** -0.5), t(H, dh, sc=0.1), t(H, dh, sc=0.1)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    r = torch.matmul(fm._pos_table(T, D, dev), wr.to(bf))
    out = torch.empty(T, B, H, dh, dtype=bf, device=dev)
    strides = [st for a in (q, k, v) for st in a.stride()[:3]]
    vec = fm._copy_width(dh, (q, k, v, r))

    def launch(lib):
        err = lib.flash_mhsa_rel_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(),
            u.data_ptr(), vb.data_ptr(), lens.data_ptr(), out.data_ptr(), B,
            H, T, dh, *strides, 1.0 / math.sqrt(dh), 0, vec,
            torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(err, "flash_mhsa_rel probe")

    def ms(lib, iters=50):
        for _ in range(3):
            launch(lib)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch(lib)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters

    want = fm.flash_mhsa_rel_plain(q, k, v, wr, u, vb, lens).float()
    launch(libs["kernel"])
    torch.cuda.synchronize()
    err = float((out.permute(1, 2, 0, 3).float() - want).abs().max())
    print(f"kernel [{B}, {H}, {T}, {dh}] max |kernel - plain| {err}")
    times = {"kernel": [], "no_copies": []}
    for name in ("kernel", "no_copies", "no_copies", "kernel"):
        times[name].append(ms(libs[name]))
    for name, got in times.items():
        print(f"{name}: {' '.join(f'{x:.4f}' for x in got)} ms on {card}")

    lib = libs["phases"]
    buf = (ctypes.c_ulonglong * 16)()
    _lib.check(lib.prof_zero(), "prof_zero")
    launch(lib)
    torch.cuda.synchronize()
    _lib.check(lib.prof_read(buf), "prof_read")
    warps = buf[8]
    total = sum(buf[i] for i in range(8))
    print(f"phases (clock64 cycles a warp, mean over {warps} warps; "
          f"{total / warps:.0f} in all) on {card}:")
    for i, name in enumerate(PHASES):
        print(f"  {name}: {buf[i] / warps:.0f} ({100 * buf[i] / total:.1f}%)")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
