#!/usr/bin/env python3
"""Where the time of the decode kernel (`csrc/fused_decode.cu`) goes, on
one CUDA card, at three shapes of the main paths.

    python3 scripts/torch_decode_probe.py [--parent DIR ...]

DIR is the `gasr_tpu_torch/csrc` of an earlier tree, for instance
    mkdir -p .chipwork/parent && git archive <commit> gasr_tpu_torch/csrc \\
        | tar -x -C .chipwork/parent
    python3 scripts/torch_decode_probe.py \\
        --parent .chipwork/parent/gasr_tpu_torch/csrc
(--parent may be given more than once: "parent", "parent2", ...).

Builds into `gasr_tpu_torch/_build/probe_dec/` (nvcc, the flags of
`ops/cuda/_lib.py`, `-Xptxas -v` for registers and spills):
  - "kernel": `csrc/fused_decode.cu` as it is;
  - "clocks": the kernel with clock64() phase counters, the surviving
    candidates of the filter and the block barriers counted;
  - for each --parent, "parent" and "parent_clocks": DIR's
    fused_decode.cu as it is and with the same counters (the design
    before the filtered top-W, of sorted runs, a merge tree and ten
    barriers a frame, or the filtered one: the anchors are picked by
    which design DIR holds).
The counters are put in by editing a copy of the sources: every
`__syncthreads();` becomes a call that charges thread 0's wait to
"barrier wait" and counts it, and a mark after each anchor line of
`PHASES_NEW` / `PHASES_PARENT` starts a phase (an anchor that is not
found fails the probe and names it). `start_count_build` and
`frame_counts` give `chip_smoke.py` the counting build alone (no
phase marks). Thread 0 of every block charges
its cycles to the phase it is in; the sums come back after one call.

Shapes (inputs from a numpy seed): reference_large's decode (T=200,
B=256, W=100, V=47; and at B=132, one block an SM, beside it: a frame's
chain of latencies alone, without a second block's instructions to
issue), conformer_l's (T=300, B=64, W=16, V=129), and the
shallow-fusion shape of chip_smoke's phase 10b (T=600, B=32, W=64,
V=129, the `kLM` instantiation with a quantized normal table). Prints
each build's registers, its blocks an SM (the occupancy query), each
build's ys and final state against the kernel's (every build must be
bit-equal: the decode is exact), the times (CUDA events, median of 5
rounds of 3 calls, builds in turns), the phase shares a frame, barriers
a frame and survivors a frame, the vocab-sharded frame kernel's device
time a launch (`tp_frame`, decode_tp.cu, which shares the frame phases;
this tree's and each parent's) and the whole "fused_frame" TP decode
(`ctc_beam_search_tp`, n = 4 and 1 shards on this card, host clock) with
each tree's decode_tp.cu under this tree's wrappers, in turns, then the
card's name and power limit.
Imports nothing of JAX. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NPH = 12
PHASE_NAMES = ("prologue", "row load", "slot_prep", "match", "seed",
               "walk / run sorts", "merges / merge tree", "rank",
               "update / commit", "barrier wait", "epilogue", "-")
(P_PRO, P_ROW, P_PREP, P_MATCH, P_SEED, P_SORT, P_MERGE, P_RANK, P_UPD,
 P_BAR, P_EPI) = range(11)

# (file, anchor line, phase that starts after it, or before it with "^")
PHASES_PARENT = [
    ("fused_decode.cu",
     "    // ---- 1. frame row; per-slot totals and match keys", P_ROW),
    ("fused_decode.cu", "^    slot_prep(s, V, 0, nullptr);", P_PREP),
    ("fused_decode.cu", "    // ---- 2. parent match and stay candidates",
     P_MATCH),
    ("fused_decode.cu",
     "    // ---- 3. stable top-W of the W x V candidate grid", P_SORT),
    ("fused_decode.cu", "    // ---- 4. state update for slot k = tid",
     P_UPD),
    ("topk.cuh", "^  unsigned long long* mine = lists + warp * kListLen;",
     P_MERGE),
]
PHASES_NEW = [
    ("fused_decode.cu", "    // ---- 0. prefetch row t+1", P_ROW),
    ("fused_decode.cu", "    // ---- 1. parent match, stays", P_MATCH),
    ("decode_frame.cuh", "  // -- seed", P_SEED),
    ("fused_decode.cu", "    // ---- 2. filtered walk", P_SORT),
    ("topk.cuh", "    // -- flush", P_MERGE),
    ("topk.cuh", "    // -- walk", P_SORT),
    ("topk.cuh", "  // -- last flush", P_MERGE),
    ("fused_decode.cu", "    // ---- 3. rank, update", P_RANK),
    ("fused_decode.cu", "        // -- update", P_UPD),
    ("fused_decode.cu", "        // -- rank", P_RANK),
]
# anchor of the kernel's first statement, and of its epilogue
BEGIN = "  const int tid = threadIdx.x;"
END_PARENT = "  for (int i = tid; i < NF * W; i += blockDim.x) {\n" \
             "    const int f = i / W, w = i - f * W;\n    fin["
END_NEW = "  // ---- epilogue"
SURVIVOR_ANCHOR = "  // -- survivors"

PRELUDE = r"""
// probe counters (scripts/torch_decode_probe.py)
#include <cuda_runtime.h>
#define GASR_NPH %(nph)d
__device__ unsigned long long gasr_cycles[GASR_NPH + 2];
static __shared__ long long gasr_last;
static __shared__ int gasr_cur;
static __shared__ unsigned long long gasr_acc[GASR_NPH + 2];
__device__ __forceinline__ void gasr_mark(int p) {
  if (threadIdx.x == 0) {
    const long long n = clock64();
    gasr_acc[gasr_cur] += n - gasr_last;
    gasr_cur = p;
    gasr_last = n;
  }
}
__device__ __forceinline__ void gasr_sync() {
  const int save = threadIdx.x == 0 ? gasr_cur : 0;
  gasr_mark(%(bar)d);
  __syncthreads();
  if (threadIdx.x == 0) gasr_acc[GASR_NPH] += 1;   // barriers
  gasr_mark(save);
}
__device__ __forceinline__ void gasr_survivors(int n) {
  if ((threadIdx.x & 31) == 0) atomicAdd(&gasr_acc[GASR_NPH + 1], n);
}
__device__ __forceinline__ void gasr_begin() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < GASR_NPH + 2; ++i) gasr_acc[i] = 0;
    gasr_cur = 0;
    gasr_last = clock64();
  }
}
__device__ __forceinline__ void gasr_end() {
  gasr_mark(%(epi)d);
  __syncthreads();   // every warp's survivors counted
  if (threadIdx.x == 0)
    for (int i = 0; i < GASR_NPH + 2; ++i)
      atomicAdd(&gasr_cycles[i], gasr_acc[i]);
}
""" % {"nph": NPH, "bar": P_BAR, "epi": P_EPI}

EPILOGUE_ENTRIES = r"""
extern "C" int gasr_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gasr_cycles,
                                   sizeof(unsigned long long) * (GASR_NPH + 2));
}
extern "C" int gasr_probe_reset() {
  static const unsigned long long zero[GASR_NPH + 2] = {};
  return (int)cudaMemcpyToSymbol(gasr_cycles, zero, sizeof(zero));
}
"""

OCCUPANCY_ENTRY = r"""
extern "C" int gasr_probe_occupancy(int W, int V, int lm, int* blocks) {
  const size_t smem = smem_bytes(W, V, V);
  const void* k = lm ? (const void*)fused_prefix_decode_kernel<true>
                     : (const void*)fused_prefix_decode_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                        smem);
  return (int)err;
}
"""


def _insert(text: str, anchor: str, code: str) -> str:
    """`code` on a line of its own after the line that holds `anchor`, or
    before it when the anchor starts with "^"."""
    before = anchor.startswith("^")
    a = anchor[1:] if before else anchor
    if text.count(a) != 1:
        raise RuntimeError(f"probe anchor found {text.count(a)} times, "
                           f"expected once: {a!r}")
    i = text.index(a)
    if before:
        i = text.rfind("\n", 0, i) + 1
        return text[:i] + code + "\n" + text[i:]
    j = text.find("\n", i + len(a))
    return text[:j] + "\n" + code + text[j:]


def instrument(src: Path, dst: Path, phases, end_anchor: str,
               survivors: bool) -> Path:
    """Copy fused_decode.cu and the headers of `src` into `dst` with the
    probe's counters; returns the instrumented fused_decode.cu."""
    dst.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text() for p in [src / "fused_decode.cu",
                                              *src.glob("*.cuh")]}
    for name, anchor, ph in phases:
        files[name] = _insert(files[name], anchor, f"gasr_mark({ph});")
    if survivors:
        files["topk.cuh"] = _insert(files["topk.cuh"], SURVIVOR_ANCHOR,
                                    "gasr_survivors(__popc(keepmask));")
    k = files["fused_decode.cu"]
    k = _insert(k, BEGIN, "  gasr_begin();")
    k = _insert(k, "^" + end_anchor, "  gasr_end();")
    k = '#include "gasr_probe.cuh"\n' + k + EPILOGUE_ENTRIES
    if "fused_prefix_decode_info" not in k:
        k += OCCUPANCY_ENTRY
    files["fused_decode.cu"] = k
    for name, text in files.items():
        if name != "gasr_probe.cuh":
            text = text.replace("__syncthreads();", "gasr_sync();")
        (dst / name).write_text(text)
    (dst / "gasr_probe.cuh").write_text(PRELUDE)
    return dst / "fused_decode.cu"


def design(src: Path):
    """The phase anchors, epilogue anchor and survivor count that fit the
    fused_decode.cu of `src`: the filtered top-W or the design before."""
    if PHASES_NEW[0][1] in (src / "fused_decode.cu").read_text():
        return PHASES_NEW, END_NEW, True
    return PHASES_PARENT, END_PARENT, False


def _nvcc_cmd(src: Path, inc: Path, so: Path, extra=()):
    from gasr_tpu_torch.ops.cuda import _lib
    return [_lib._nvcc(), *_lib._BASE_FLAGS,
            *_lib._EXTRA_FLAGS["fused_decode"], *extra, "-I", str(inc),
            "-o", str(so), str(src)]


def start_count_build(out_dir: Path):
    """nvcc started on a copy of this tree's fused_decode.cu that counts
    its block barriers and the filter's survivors (no phase marks);
    returns (the library's path, the process)."""
    from gasr_tpu_torch.ops.cuda import _lib
    src = instrument(_lib.CSRC, out_dir / "src_count", [], END_NEW,
                     survivors=True)
    so = out_dir / "libfused_decode_count.so"
    return so, subprocess.Popen(_nvcc_cmd(src, src.parent, so),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load_build(so: Path) -> ctypes.CDLL:
    """A probe build with the argument types of `ops/cuda/_lib.py`."""
    from gasr_tpu_torch.ops.cuda import _lib
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _lib.SIGNATURES["fused_decode"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def frame_counts(lib: ctypes.CDLL, frames: int):
    """(barriers, survivors) a block-frame over the calls of an
    instrumented build since its last `gasr_probe_reset`; frames: T * B."""
    buf = (ctypes.c_ulonglong * (NPH + 2))()
    if lib.gasr_probe_read(buf) != 0:
        raise RuntimeError("probe read failed")
    return buf[NPH] / frames, buf[NPH + 1] / frames


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="csrc directory of an earlier tree (repeatable)")
    ap.add_argument("--parent-only", action="store_true",
                    help="only the earlier trees' builds")
    args = ap.parse_args()

    import torch

    from gasr_tpu_torch.decoder.beam_search import _init_beam, _quantize_lm
    from gasr_tpu_torch.ops.cuda import _lib, fused_decode
    from gasr_tpu_torch.parallel import decode_tp
    from gasr_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        print("torch_decode_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")

    out_dir = _lib.BUILD / "probe_dec"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}          # name -> (source, include dir, extra flags)
    trees = {}           # name -> csrc directory, for decode_tp.cu
    if not args.parent_only:
        builds["kernel"] = (_lib.CSRC / "fused_decode.cu", _lib.CSRC, [])
        trees["kernel"] = _lib.CSRC
        src = instrument(_lib.CSRC, out_dir / "src_clocks", PHASES_NEW,
                         END_NEW, survivors=True)
        builds["clocks"] = (src, src.parent, [])
    for i, parent in enumerate(args.parent):
        name = "parent" if i == 0 else f"parent{i + 1}"
        print(f"{name}: {parent}", flush=True)
        builds[name] = (parent / "fused_decode.cu", parent, [])
        trees[name] = parent
        phases, end, surv = design(parent)
        src = instrument(parent, out_dir / f"src_{name}_clocks", phases, end,
                         survivors=surv)
        builds[f"{name}_clocks"] = (src, src.parent, [])
    procs = []
    for name, (src, inc, extra) in builds.items():
        so = out_dir / f"libfused_decode_{name}.so"
        procs.append((name, so, subprocess.Popen(
            _nvcc_cmd(src, inc, so, [*extra, "-Xptxas", "-v"]),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    # each tree's decode_tp.cu (the vocab-sharded kernels), built alongside;
    # trees from before the merged frame kernel have other C entries
    tp_procs = []
    for name, src in trees.items():
        if "tp_scan_cluster_launch" not in (src / "decode_tp.cu").read_text():
            print(f"{name}: decode_tp.cu has an earlier C interface; its "
                  f"vocab-sharded kernels are not timed", flush=True)
            continue
        so = out_dir / f"libdecode_tp_{name}.so"
        tp_procs.append((name, so, subprocess.Popen(
            [_lib._nvcc(), *_lib._BASE_FLAGS, *_lib._EXTRA_FLAGS["decode_tp"],
             "-I", str(src), "-o", str(so), str(src / "decode_tp.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    failed = []
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            failed.append(name)
            continue
        regs = re.findall(r"Function properties for (\S+)\n.*?\n.*?Used "
                          r"(\d+) registers", log, re.S)
        dec = [(f, r) for f, r in re.findall(
            r"Compiling entry function '(\S*fused_prefix_decode\S*)'.*?"
            r"Used (\d+) registers", log, re.S)]
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"{name}: decode kernel registers "
              f"{[r for _, r in dec] or regs}, spill stores {spills}",
              flush=True)
        libs[name] = load_build(so)
    if failed:
        raise RuntimeError(f"builds failed: {failed}")

    def use(name):
        _lib._loaded["fused_decode"] = libs[name]

    rng = np.random.default_rng(10)

    def log_softmax(z):
        z = z - z.max(-1, keepdims=True)
        return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(
            np.float32)

    shapes = {}
    for tag, (T, B, W, V, lm) in {
            "reference_large T=200 B=256 W=100 V=47": (200, 256, 100, 47,
                                                       False),
            # one block an SM: a frame's chain alone, no second block
            "reference_large at B=132 T=200 W=100 V=47": (200, 132, 100, 47,
                                                          False),
            "conformer_l T=300 B=64 W=16 V=129": (300, 64, 16, 129, False),
            "LM T=600 B=32 W=64 V=129": (600, 32, 64, 129, True)}.items():
        lp = torch.from_numpy(log_softmax(
            rng.standard_normal((T, B, V)))).to(dev)
        lm_q = _quantize_lm(torch.from_numpy(rng.standard_normal(
            (V + 1, V)).astype(np.float32)), V, dev) if lm else None
        shapes[tag] = (lp, _init_beam(B, W, dev), lm_q, (T, B, W, V))

    def run(tag):
        lp, init, lm_q, _ = shapes[tag]
        return fused_decode.fused_prefix_decode(lp, init, lm_q=lm_q)

    # every build against the kernel (or the parent): bit-equal
    ref_build = "kernel" if "kernel" in libs else "parent"
    for tag in shapes:
        use(ref_build)
        fin0, ys0 = run(tag)
        want = fused_decode.pack_state(fin0)
        for name in libs:
            use(name)
            fin, ys = run(tag)
            torch.cuda.synchronize()
            if not (torch.equal(ys, ys0)
                    and torch.equal(fused_decode.pack_state(fin), want)):
                raise RuntimeError(f"{name} differs from {ref_build} ({tag})")
        print(f"{tag}: every build's ys and final state == {ref_build}'s",
              flush=True)

    for name, lib in libs.items():
        for tag, (_, _, lm_q, (T, B, W, V)) in shapes.items():
            blocks, regs, smem, extra = (ctypes.c_int(0) for _ in range(4))
            info = getattr(lib, "fused_prefix_decode_info", None)
            if info is not None:
                # an earlier tree's entry took a fourth output; this
                # tree's ignores it
                info.argtypes = [ctypes.c_int] * 3 + [
                    ctypes.POINTER(ctypes.c_int)] * 4
                info.restype = ctypes.c_int
                _lib.check(info(W, V, int(lm_q is not None),
                                ctypes.byref(blocks), ctypes.byref(regs),
                                ctypes.byref(smem), ctypes.byref(extra)),
                           "fused_prefix_decode_info")
                print(f"{name} {tag}: {blocks.value} blocks an SM (occupancy "
                      f"query), {regs.value} registers, {smem.value} bytes "
                      f"of dynamic shared memory requested a block",
                      flush=True)
            elif hasattr(lib, "gasr_probe_occupancy"):
                occ = lib.gasr_probe_occupancy
                occ.argtypes = [ctypes.c_int] * 3 + [
                    ctypes.POINTER(ctypes.c_int)]
                occ.restype = ctypes.c_int
                _lib.check(occ(W, V, int(lm_q is not None),
                               ctypes.byref(blocks)), "occupancy")
                print(f"{name} {tag}: {blocks.value} blocks an SM (occupancy "
                      f"query)", flush=True)

    def cuda_ms(fn, iters=3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    times = {(name, tag): [] for name in libs for tag in shapes}
    for _ in range(5):
        for tag in shapes:
            for name in libs:
                use(name)
                times[name, tag].append(cuda_ms(lambda: run(tag)))
    sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"SM clock after the timing rounds (now, max): {sm_clock.strip()}")
    for (name, tag), ts in times.items():
        print(f"{name} {tag}: {float(np.median(ts)):.4f} ms (median of 5; "
              f"rounds {[round(x, 4) for x in ts]}) on {card}", flush=True)

    for name in [n for n in libs if n.endswith("clocks")]:
        lib = libs[name]
        buf = (ctypes.c_ulonglong * (NPH + 2))()
        for tag in shapes:
            T, B = shapes[tag][3][:2]
            use(name)
            _lib.check(lib.gasr_probe_reset(), "probe reset")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(tag)
            end.record()
            end.synchronize()
            _lib.check(lib.gasr_probe_read(buf), "probe read")
            cyc = np.array(buf[:NPH], dtype=np.float64)
            frames = T * B
            shares = ", ".join(
                f"{PHASE_NAMES[i]} {100 * x / cyc.sum():.1f}% "
                f"({x / frames:.0f} cycles a frame)"
                for i, x in enumerate(cyc) if x > 0)
            print(f"{name} {tag} phases (thread 0 of each of {B} blocks, "
                  f"{T} frames): {shares}; barriers a frame "
                  f"{buf[NPH] / frames:.2f}"
                  + (f"; survivors a frame {buf[NPH + 1] / frames:.1f}"
                     if buf[NPH + 1] else "")
                  + f"; a block-frame {cyc.sum() / frames:.0f} cycles, call "
                  f"{start.elapsed_time(end):.4f} ms", flush=True)
    # the vocab-sharded frame kernel (decode_tp.cu shares the phases): its
    # device time a launch (torch.profiler), each tree's in turns; a call's time by CUDA events is mostly the wrapper's host
    # work at this size
    tp_libs = {}
    for name, so, proc in tp_procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"decode_tp.cu of {name} failed to build:\n"
                               f"{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _lib.SIGNATURES["decode_tp"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        tp_libs[name] = lib
    lp, init, _, (T, B, W, V) = shapes["reference_large T=200 B=256 W=100 "
                                        "V=47"]
    beam, _ = fused_decode.fused_prefix_decode_plain(lp[:5], init)
    st = fused_decode.pack_state(beam)
    f = lp[5]
    f_last = torch.gather(f, 1, st[fused_decode.FIELDS.index("last")]
                          .long().clamp(0, V - 1))
    lo, hi = fused_decode.shard_bounds(V, 4)[1]
    tp_args = (f[:, lo:hi], f_last, f[:, 0].contiguous(), st, lo, hi, V, 0)
    dev_us = {name: [] for name in tp_libs}
    for name in [*tp_libs, *reversed(tp_libs)] * 2:
        _lib._loaded["decode_tp"] = tp_libs[name]
        fused_decode.tp_frame(*tp_args)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fused_decode.tp_frame(*tp_args)
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "tp_frame" in e.key]
        dev_us[name].append(sum(e.device_time_total for e in ks)
                            / max(1, sum(e.count for e in ks)))
    for name, us in dev_us.items():
        print(f"tp_frame {name} (B={B}, W={W}, window [{lo}, {hi}) of "
              f"V={V}): {float(np.median(us)):.2f} us a kernel on the device "
              f"(torch.profiler, median of {len(us)} turns of 50 launches: "
              f"{[round(u, 2) for u in us]}) on {card}", flush=True)
    # the whole "fused_frame" TP decode (T x n tp_frame launches, each
    # with its host work) under each tree's decode_tp.cu, in turns
    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    meshes = {n_: make_mesh({"model": n_}, devices=[dev] * n_)
              for n_ in (4, 1)}
    whole = {(name, n_): [] for name in tp_libs for n_ in meshes}
    for name in [*tp_libs, *reversed(tp_libs)] * 3:
        _lib._loaded["decode_tp"] = tp_libs[name]
        for n_, mesh in meshes.items():
            def tp_decode():
                decode_tp.ctc_beam_search_tp(lp, beam_width=W, mesh=mesh,
                                             max_len=256,
                                             tp_impl="fused_frame")
            tp_decode()                                      # warm-up
            whole[name, n_].append(host_ms(tp_decode))
    for (name, n_), ms in whole.items():
        print(f"ctc_beam_search_tp 'fused_frame' n={n_} with {name}'s "
              f"decode_tp.cu (T={T}, B={B}, W={W}, V={V}): "
              f"{float(np.median(ms)):.3f} ms (host clock, median of "
              f"{len(ms)} turns: {[round(x, 3) for x in ms]}) on {card}",
              flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
