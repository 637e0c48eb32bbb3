#!/usr/bin/env python3
"""Where the time of the fused stem goes, on one CUDA card, at
conformer_l's shape.

    python3 scripts/torch_stem_probe.py

Builds five libraries from `gasr_tpu_torch/csrc/stem.cu` into
`gasr_tpu_torch/_build/probe_stem/` (nvcc, the flags of `ops/cuda/_lib.py`,
`-Xptxas -v` for registers and spills):
  - the kernels as they are;
  - "h1_read": the conv kernel reading a precomputed h1 [B, T/2, F/2, d]
    bf16 from device memory in place of computing it from x (conv1's
    epilogue a load; the plain version's conv1 supplies h1);
  - "no_conv1": the conv1 warps skip chunks 1.. (time only: the results
    are wrong);
  - "mma_only": no_conv1 without the w2 copies; "skeleton": mma_only
    without conv2's products (time only);
  - "phases": the kernel with clock64() counters around the parts of a
    tap (read back after one launch);
  - "no_w2_copies": without the w2 copies of the tap loop, the ring's
    barriers kept (time only);
  - "no_mma": without conv2's products (time only).
Inputs: x [64, 1200, 80] float32, d = dout = 512, from a numpy seed. Prints
each build's registers; the error of one call against
`fused_stem_plain` and of the h1_read build's h2 against the kernel's;
times (CUDA events, 5 launches after a warm-up, in turns: the variants,
then in reverse order) of the conv kernel alone in each build, of the
sub_proj kernel alone, of the whole call and of the plain version; then
`torch.profiler`'s list of the device kernels of one `fused_stem` call
(a cuDNN or cuBLAS convolution or GEMM among them fails the probe), and
the card's name and power limit. Imports nothing of JAX. Needs a card.
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

MMA_LINE = "      wgmma<BN>(acc, a[ks], b_desc(ws + 16 * ks));\n"
CONV1_EPILOGUE = """\
            if (!(e & kZero)) {   // conv1 at this position: + b1, clip
              y0 = clip20(c[2 * h] + bb[j][0]);
              y1 = clip20(c[2 * h + 1] + bb[j][1]);
            }"""
H1_LOAD = """\
            if (!(e & kZero)) {   // h1 read (probe): position -> (r, c)
              const int r_ = (e & ~kZero) / PW, sl_ = (e & ~kZero) % PW;
              const int c_ = sl_ < HE ? 2 * sl_ : 2 * (sl_ - HE) + 1;
              const __nv_bfloat162 v_ =
                  *reinterpret_cast<const __nv_bfloat162*>(
                      reinterpret_cast<const bf16*>(x) +
                      (((long long)b * T1 + 2 * tl.ta + r_) * F1 +
                       2 * tl.fa + c_) * d + cc * CK + ch);
              y0 = __low2float(v_);
              y1 = __high2float(v_);
            }"""
CONV1_WARPS = ("      produce(region + (cc & 1) * P_max * LDA, cc, "
               "warp - kWarps - 1,\n              kConv1Warps);\n")


def _no_copies(src: str, once) -> str:
    """The conv kernel's w2 ring without its bulk copies: each stage's
    barrier expects 0 bytes (the sub_proj kernel of this build is not
    run)."""
    i = src.index('    asm volatile(\n        "cp.async.bulk.shared::cluster')
    j = src.index("  __device__ __forceinline__ void wait(int s) const {", i)
    return once(src[:i] + "  }\n" + src[j:],
                "kStage * (int)sizeof(bf16));", "0);")


PHASES = ["prologue", "wait for the region", "-", "wait for w2",
          "A loads + wgmma issue", "wgmma wait", "release", "epilogue"]


def _phases(src: str, once) -> str:
    """The conv kernel with clock64() counters around the parts of a tap
    (lane 0 of each warp sums them into g_prof after its epilogue)."""
    p = src.replace("namespace {\n", "__device__ unsigned long long "
                    "g_prof[16];\nnamespace {\n", 1)
    p = once(p, "  const int T1 = T / 2, F1 = F / 2, T2 = T / 4, F2 = F / 4;\n",
             "  const long long t_start = clock64();\n"
             "  const int T1 = T / 2, F1 = F / 2, T2 = T / 4, F2 = F / 4;\n")
    head = ("  auto tap_step = [&](int s, uint32_t (&a)[2][4],\n"
            "                      uint32_t (&a_prev)[2][4]) {\n")
    p = once(p, head,
             "  long long tc = clock64();\n"
             "  unsigned long long ph[8] = {(unsigned long long)(tc - "
             "t_start)};\n"
             "#define TICK(i) { long long t_ = clock64(); ph[i] += t_ - tc; "
             "tc = t_; }\n" + head + "    TICK(6)\n")
    p = once(p, "      mbar_wait(reg_full + (cc & 1), ((cc - 1) >> 1) & 1);\n",
             "      mbar_wait(reg_full + (cc & 1), ((cc - 1) >> 1) & 1);\n"
             "    TICK(1)\n")
    p = once(p, "    rg.wait(s);\n    const bf16* reg",
             "    rg.wait(s);\n    TICK(3)\n    const bf16* reg")
    p = once(p, "    wgmma_commit();\n    wgmma_wait<1>();                 "
                "// stage s - 1's products are done\n",
             "    wgmma_commit();\n    TICK(4)\n    wgmma_wait<1>();\n"
             "    TICK(5)\n")
    p = once(p, "          *reinterpret_cast<const uint4*>(st + m * SLD + c);"
                "\n    }\n  }\n}",
             "          *reinterpret_cast<const uint4*>(st + m * SLD + c);"
             "\n    }\n  }\n  TICK(7)\n  if (lane == 0) {\n"
             "    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], ph[i]);\n"
             "    atomicAdd(&g_prof[8], 1ull);\n  }\n}")
    p += ('\nextern "C" int prof_read(unsigned long long* h) {\n'
          "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n"
          "}\n"
          'extern "C" int prof_zero() {\n'
          "  unsigned long long z[16] = {};\n"
          "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
          "}\n")
    return p


def _variants(src: str) -> dict:
    """The source and its probe builds (edits anchored on lines of the
    source; an anchor that is gone raises)."""
    def once(s, old, new):
        if s.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once: {old!r}")
        return s.replace(old, new)

    no_conv1 = once(src, CONV1_WARPS, "")
    mma_only = _no_copies(no_conv1, once)
    return {
        "kernel": src,
        "mma_only": mma_only,
        "skeleton": once(mma_only, MMA_LINE, "      (void)0;\n"),
        "h1_read": once(src, CONV1_EPILOGUE, H1_LOAD),
        "no_conv1": no_conv1,
        "no_w2_copies": _no_copies(src, once),
        "phases": _phases(src, once),
        "no_h2_store": once(src, "      *reinterpret_cast<uint4*>(h2 + row * "
                                 "d + n0 + c) =\n",
                            "      if (m < 0) *reinterpret_cast<uint4*>(h2 + "
                            "row * d + n0 + c) =\n"),
        "no_mma": once(src, MMA_LINE, "      (void)0;\n"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    from gasr_tpu_torch.ops.conv import conv2d
    from gasr_tpu_torch.ops.cuda import _lib, stem

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    out_dir = _lib.BUILD / "probe_stem"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = _variants((_lib.CSRC / "stem.cu").read_text())
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
        lines = log.splitlines()
        regs = [(" ".join(re.search(r"stem_(conv|proj)_kernelILi(\d+)",
                                    ln).groups()),
                 nxt.split("Used", 1)[1].strip(), spill.strip())
                for ln, spill, nxt in zip(lines, lines[2:], lines[3:])
                if "Compiling entry" in ln]
        print(f"{name}: {regs}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        if name == "phases":
            lib.prof_read.argtypes = [ctypes.c_void_p]
        for fn, argtypes in _lib.SIGNATURES["stem"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    bf = torch.bfloat16
    B, T, F, d, dout = 64, 1200, 80, 512, 512
    T2, F2 = T // 4, F // 4
    rng = np.random.default_rng(0)

    def t(*shape, sc):
        return torch.from_numpy((rng.standard_normal(shape) * sc).astype(
            np.float32)).to(dev)
    x = torch.from_numpy(rng.uniform(size=(B, T, F)).astype(np.float32)).to(
        dev)
    w = (t(3, 3, 1, d, sc=0.2), t(d, sc=0.1), t(3, 3, d, d, sc=(9 * d) ** -0.5),
         t(d, sc=0.1), t(F2 * d, dout, sc=(F2 * d) ** -0.5 * 2),
         t(dout, sc=0.1))
    w1k = torch.zeros(d, 16, dtype=bf, device=dev)
    w1k[:, :9] = w[0].reshape(9, d).t()
    w2k = stem.conv_w2_stages(w[2])
    wpk = stem.proj_wp_stages(w[4])
    b1f, b2f = w[1].contiguous(), w[3].contiguous()
    bpf = w[5].to(bf).float().contiguous()
    h1 = conv2d({"w": w[0], "b": w[1]}, x[..., None], (2, 2),
                compute_dtype=bf).contiguous()
    h2 = {n: torch.empty(B, T2, F2, d, dtype=bf, device=dev)
          for n in ("kernel", "h1_read")}
    scratch = torch.empty(B, T2, F2, d, dtype=bf, device=dev)
    out = torch.empty(B, T2, dout, dtype=bf, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def conv(name):
        lib = libs[name]
        src = h1 if name == "h1_read" else x
        dst = h2.get(name, scratch)
        _lib.check(lib.stem_conv_launch(
            src.data_ptr(), *x.stride(), w1k.data_ptr(), b1f.data_ptr(),
            w2k.data_ptr(), b2f.data_ptr(), dst.data_ptr(), B, T, F, d,
            stem.f2_windows(F2), stream), f"stem_conv {name}")

    def proj():
        _lib.check(libs["kernel"].stem_proj_launch(
            h2["kernel"].data_ptr(), wpk.data_ptr(), bpf.data_ptr(), B * T2,
            F2 * d, dout, 0, out.data_ptr(), stream), "stem_proj")

    def ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters

    want = stem.fused_stem_plain(x, *w)
    got = stem.fused_stem(x, *w)
    conv("kernel")
    conv("h1_read")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    h_err = float((h2["h1_read"].float() - h2["kernel"].float()).abs().max())
    print(f"fused_stem [{B}, {T}, {F}] d={d}: max |kernel - plain| {err} "
          f"(max |plain| {float(want.float().abs().max())}); h2 of h1_read "
          f"against the kernel's: max diff {h_err} (h1 from cuDNN rounds "
          f"conv1 before b1)", flush=True)

    order = [n for n in srcs if n != "phases"]
    times = {n: [] for n in order}
    for name in order + order[::-1]:
        times[name].append(ms(lambda: conv(name)))
    for name in order:
        print(f"conv kernel, {name}: "
              f"{' '.join(f'{v:.4f}' for v in times[name])} ms on {card}")
    whole = [ms(lambda: stem.fused_stem(x, *w))]
    plain = ms(lambda: stem.fused_stem_plain(x, *w), iters=3)
    whole.append(ms(lambda: stem.fused_stem(x, *w)))
    print(f"sub_proj kernel: {ms(proj):.4f} ms; whole call "
          f"{' '.join(f'{v:.4f}' for v in whole)} ms; plain version "
          f"{plain:.4f} ms on {card}", flush=True)

    lib = libs["phases"]
    buf = (ctypes.c_ulonglong * 16)()
    _lib.check(lib.prof_zero(), "prof_zero")
    conv("phases")
    torch.cuda.synchronize()
    _lib.check(lib.prof_read(buf), "prof_read")
    warps = buf[8]
    total = sum(buf[i] for i in range(8))
    print(f"conv kernel phases (clock64 cycles a warp, mean over {warps} "
          f"warps; {total / warps:.0f} in all) on {card}:")
    for i, name in enumerate(PHASES):
        if buf[i]:
            print(f"  {name}: {buf[i] / warps:.0f} "
                  f"({100 * buf[i] / total:.1f}%)")

    from torch.profiler import ProfilerActivity, profile
    stem.fused_stem(x, *w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stem.fused_stem(x, *w)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, getattr(e, "device_time_total",
                                     getattr(e, "cuda_time_total", 0)))
            for e in prof.key_averages()
            if getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0)) > 0]
    print("device kernels of one fused_stem call (torch.profiler):")
    for key, count, us in sorted(rows, key=lambda r: -r[2]):
        print(f"  {key}: {count} x, {us / 1e3:.4f} ms")
    lib_names = [k for k, _, _ in rows
                 if any(s in k.lower() for s in ("cudnn", "cublas", "gemm",
                                                 "conv2d", "convolution",
                                                 "sm90_xmma", "cutlass"))
                 and "stem_" not in k]
    print(f"library convolutions or GEMMs among them: {lib_names or 'none'}")
    print(f"card: {card}")
    return 1 if lib_names else 0


if __name__ == "__main__":
    sys.exit(main())
