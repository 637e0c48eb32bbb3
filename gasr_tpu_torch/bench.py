"""The port's benchmark: one JSON line of audio-seconds/s, as the JAX
package's `bench.py` prints it.

    python -m gasr_tpu_torch.bench [--small] [--config PRESET] [--iters N]
        [--baseline-iters N] [--no-decode] [--fault-inject] [--report]
        [--device cuda|cpu]

Protocol (the reference's harness, baseline/main.py:38-56): the forward
and the CTC beam-search decode of one batch timed apart, their sum the
overall time; audio-seconds/s counts 10 ms a frame (T = 200 frames = 2 s
of audio an utterance). Times are the host clock around N calls and one
device fence (`runtime.timer.Timer.sync`), the median of 5 such loops.

vs_baseline: the ratio of the PyTorch CPU twin's overall time (torch
`nn.RNN` forward on 4 threads, the port's native C++ beam decoder) to
ours, measured in the same process and cached in
`gasr_tpu_torch/_build/bench_baseline.json` (`.small` for --small).

--report benches the five model-family presets, the streaming row and the
two training rows (`TRAIN_ROWS`: one step of forward, CTC loss,
backward, clip and AdamW, timed as N steps and one fence, median of 5
loops, with MFU against `runtime/flops.model_train_flops`, the peak
device memory, the step's split and the TF32 settings it ran under: off
for matmuls and cuDNN, as `chip_smoke.py` runs the step) and
writes the table to `gasr_tpu_torch/_build/RESULTS.md`. --scaling writes
the weak-scaling artifact `gasr_tpu_torch/_build/SCALING.json`
(`run_scaling`; cards only). Everything runs on the card unless
`--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from gasr_tpu_torch.config import PRESETS, Config, resolve_device
from gasr_tpu_torch.runtime.timer import Timer

FRAME_SHIFT_S = 0.01  # standard 10 ms hop
BUILD = Path(__file__).resolve().parent / "_build"


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _spread_stats(samples):
    """Per-rep sample list -> {median, min, max, iqr} (seconds)."""
    ss = sorted(samples)
    n = len(ss)
    med = statistics.median(ss)
    if n >= 4:
        q1 = statistics.median(ss[: n // 2])
        q3 = statistics.median(ss[-(n // 2):])
        iqr = q3 - q1
    else:
        iqr = ss[-1] - ss[0]
    return {"median": med, "min": ss[0], "max": ss[-1], "iqr": iqr,
            "reps": n}


def _compute_dtype(cfg: Config):
    return None if cfg.compute_dtype == "float32" else getattr(
        torch, cfg.compute_dtype)


def _inputs(cfg: Config, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand((cfg.batch_size, cfg.seg_len, cfg.feat_size),
                      generator=gen).to(device)


def measure_ours(cfg: Config, iters: int, decode: bool = True,
                 adaptive: bool = False, reps: int = 5):
    """The forward and the decode of `iters` batches, each timed as
    `iters` calls then one fence, `reps` times; medians and spread.

    adaptive=True re-derives `iters` from one fenced probe call so that
    each timed loop covers about 1 s (3 to 100 calls). Params from
    `model_init` (seed 0), inputs uniform from a seeded generator; the
    model runs `cfg.rnn_impl` and `cfg.compute_dtype`."""
    from gasr_tpu_torch.decoder import ctc_beam_search
    from gasr_tpu_torch.models import model_apply, model_init

    dev = resolve_device(cfg.device)
    params = model_init(cfg, torch.Generator().manual_seed(0),
                        device=cfg.device)
    cd = _compute_dtype(cfg)

    def fwd(x):
        with torch.no_grad():
            return model_apply(cfg, params, x, rnn_impl=cfg.rnn_impl,
                               compute_dtype=cd)

    def dec(lp):
        return ctc_beam_search(lp, beam_width=cfg.beam_width,
                               blank_id=cfg.blank_id,
                               max_len=cfg.decode_max_len,
                               algorithm="prefix")

    _log("generating inputs")
    gen = torch.Generator().manual_seed(1)
    x0 = _inputs(cfg, gen, dev)
    _log("warm-up forward" + (" and decode" if decode else ""))
    lp = fwd(x0)
    Timer.sync(lp)
    if decode:
        Timer.sync(dec(lp))
    if adaptive:
        # one fenced probe call sizes the timed loop
        t0 = time.perf_counter()
        r = fwd(x0)
        if decode:
            r = dec(r)
        Timer.sync(r)
        t_est = max(time.perf_counter() - t0, 1e-4)
        iters = min(100, max(3, math.ceil(1.0 / t_est)))
        _log(f"adaptive iters: ~{t_est * 1e3:.1f} ms/iter -> {iters} "
             f"x {reps} reps")
    xs = [x0] + [_inputs(cfg, gen, dev) for _ in range(iters - 1)]
    Timer.sync(xs)
    _log("warm-up done, timing")

    # timed loops: N calls then one fence (throughput protocol: the
    # launches queue as in serving), repeated `reps` times for a spread
    fwd_reps, dec_reps = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        lps = [fwd(x) for x in xs]
        Timer.sync(lps[-1])
        fwd_reps.append((time.perf_counter() - t0) / iters)
        if decode:
            t0 = time.perf_counter()
            results = [dec(lp) for lp in lps]
            Timer.sync(results[-1])
            dec_reps.append((time.perf_counter() - t0) / iters)
        del lps
    fstats = _spread_stats(fwd_reps)
    dstats = _spread_stats(dec_reps) if decode else None
    t_fwd = fstats["median"]
    t_dec = dstats["median"] if decode else 0.0
    _log(f"ours: fwd={t_fwd:.4f}s dec={t_dec:.4f}s per iter (median of "
         f"{reps}; fwd range {fstats['min']:.4f}-{fstats['max']:.4f})")
    return {"forward_s": t_fwd, "decode_s": t_dec,
            "overall_s": t_fwd + t_dec,
            "forward_stats": fstats, "decode_stats": dstats,
            "iters": iters}


def measure_torch_baseline(cfg: Config, iters: int, cache_path):
    """The PyTorch twin on the CPU (reference config 1: cfg.num_threads
    threads): `nn.Linear` / `nn.RNN` forward, the native C++ beam
    decoder. Cached at `cache_path`."""
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            return json.load(f)
    _log("measuring torch CPU baseline (uncached)")
    import torch.nn as nn
    from gasr_tpu_torch.native import cpu_beam_decode_batch

    threads = torch.get_num_threads()
    torch.set_num_threads(cfg.num_threads)
    gen = torch.Generator().manual_seed(2)
    feat, L, H, out = (cfg.feat_size, cfg.linear_size, cfg.rnn_hidden_size,
                       cfg.output_size)
    mlp123 = nn.Sequential(nn.Linear(feat, L), nn.ReLU(),
                           nn.Linear(L, L), nn.ReLU(),
                           nn.Linear(L, H), nn.ReLU())
    rnn = nn.RNN(H, H, num_layers=1)
    mlp56 = nn.Sequential(nn.Linear(H, L), nn.ReLU(), nn.Linear(L, out))

    def forward(x):
        b, t = x.size(0), x.size(1)
        x = x.permute(1, 0, 2).reshape(t * b, -1)
        x = mlp123(x).reshape(t, b, -1)
        x, _ = rnn(x)
        x = mlp56(x.reshape(t * b, -1))
        return x.reshape(t, b, -1).log_softmax(2)

    t_fwd = t_dec = 0.0
    try:
        with torch.no_grad():
            forward(torch.rand(cfg.batch_size, cfg.seg_len, feat,
                               generator=gen))
            for _ in range(iters):
                x = torch.rand(cfg.batch_size, cfg.seg_len, feat,
                               generator=gen)
                t0 = time.perf_counter()
                lp = forward(x)
                t1 = time.perf_counter()
                cpu_beam_decode_batch(lp.numpy(), cfg.beam_width,
                                      cfg.blank_id,
                                      num_threads=cfg.num_threads)
                t2 = time.perf_counter()
                t_fwd += t1 - t0
                t_dec += t2 - t1
    finally:
        torch.set_num_threads(threads)
    result = {"forward_s": t_fwd / iters, "decode_s": t_dec / iters,
              "overall_s": (t_fwd + t_dec) / iters,
              "decode_included": True}
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump(result, f)
    return result


def _train_setup(cfg: Config, compute_dtype):
    """Params (seed 0), optimizer state, step and one fixed batch (seed 1,
    `synthetic_batch`) at the config's shape, on its device."""
    from gasr_tpu_torch.models import model_init
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      synthetic_batch)
    cd = compute_dtype
    if cd is None and cfg.compute_dtype != "float32":
        cd = cfg.compute_dtype
    params = model_init(cfg, torch.Generator().manual_seed(0),
                        device=cfg.device)
    opt = make_optimizer()
    state = opt.init(params)
    step = make_train_step(cfg, opt, compute_dtype=cd)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
    return params, state, step, batch


def measure_train(cfg: Config, iters=None, reps: int = 5,
                  compute_dtype=None):
    """Time the training step (forward + CTC loss + backward + clip +
    AdamW, params updated in place) at the config's shape, on one fixed
    batch, as the JAX package's `measure_train` does: a warm-up step, then
    `reps` loops of `iters` steps and one fence (iters=None sizes a loop
    to about 1 s, 3 to 100 steps). compute_dtype overrides the config's
    policy. Returns the spread stats (seconds a step) with `peak_bytes`
    (the peak device memory of the run above what was allocated before
    it: params, optimizer state, batch, activations; CUDA only) and
    `losses` (every step's loss, in order)."""
    dev = resolve_device(cfg.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    params, state, step, batch = _train_setup(cfg, compute_dtype)
    losses = []

    def run(n):
        nonlocal params, state
        for _ in range(n):
            params, state, m = step(params, state, batch)
            losses.append(m["loss"])
        Timer.sync(losses[-1])

    _log("warm-up train step")
    run(1)
    if iters is None:
        t0 = time.perf_counter()
        run(1)
        t_est = max(time.perf_counter() - t0, 1e-4)
        iters = min(100, max(3, math.ceil(1.0 / t_est)))
        _log(f"adaptive train iters: ~{t_est * 1e3:.1f} ms -> {iters} x "
             f"{reps} reps")
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(iters)
        samples.append((time.perf_counter() - t0) / iters)
    st = _spread_stats(samples)
    st["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) - base
                        if dev.type == "cuda" else None)
    st["losses"] = [float(v) for v in losses]
    _log(f"train: {st['median'] * 1e3:.1f} ms/step (range "
         f"{st['min'] * 1e3:.1f}-{st['max'] * 1e3:.1f})")
    return st


SPLIT_STEPS = 3  # steps averaged by measure_train_split, after one warm-up
TRAIN_PHASES = ("forward", "ctc", "backward", "optimizer")


def measure_train_split(cfg: Config, compute_dtype=None) -> dict:
    """Where a training step's time goes: the step `measure_train` times,
    with a CUDA event recorded as each of its phases ends (the forward,
    the CTC loss, the backward, clip + AdamW: `make_train_step`'s `mark`);
    ms each, means over SPLIT_STEPS steps after one warm-up step. Device
    time between the events, so a phase the host holds back (the CTC
    loss's T-step loop) counts its waits."""
    dev = resolve_device(cfg.device)
    if dev.type != "cuda":
        raise ValueError("measure_train_split times CUDA events: it needs "
                         "the card")
    params, state, step, batch = _train_setup(cfg, compute_dtype)
    totals = dict.fromkeys(TRAIN_PHASES, 0.0)
    for i in range(SPLIT_STEPS + 1):
        events = {}

        def mark(phase):
            events[phase] = torch.cuda.Event(enable_timing=True)
            events[phase].record()

        mark("start")
        params, state, _ = step(params, state, batch, mark=mark)
        events["optimizer"].synchronize()
        if i:
            prev = events["start"]
            for phase in TRAIN_PHASES:
                totals[phase] += prev.elapsed_time(events[phase])
                prev = events[phase]
    return {phase: t / SPLIT_STEPS for phase, t in totals.items()}


# training rows for --report: (row name, preset, compute_dtype override),
# the JAX package's TRAIN_ROWS
TRAIN_ROWS = [
    ("train_flagship", "reference_large", None),
    ("train_conformer_l_bf16", "conformer_l", "bfloat16"),
]


REPORT_PRESETS = ["reference_large", "bilstm_2x256", "deepspeech2",
                  "conformer_s", "conformer_l"]


def measure_streaming(cfg: Config, chunk_frames: int, iters=None,
                      reps: int = 5):
    """The chunked streaming decode at the preset's shape: the forward
    once, then `iters` whole streaming decodes (T / chunk_frames
    `streaming_step` calls each, beam and prefix state carried across
    chunks), `reps` timed loops; spread stats of one utterance batch's
    decode. iters=None sizes the loop to about 1 s."""
    from gasr_tpu_torch.decoder.beam_search import (streaming_init,
                                                    streaming_step)
    from gasr_tpu_torch.models import model_apply, model_init

    dev = resolve_device(cfg.device)
    params = model_init(cfg, torch.Generator().manual_seed(0),
                        device=cfg.device)
    x = _inputs(cfg, torch.Generator().manual_seed(1), dev)
    with torch.no_grad():
        lp = model_apply(cfg, params, x)
    Timer.sync(lp)
    n_chunks = cfg.seg_len // chunk_frames
    assert n_chunks * chunk_frames == cfg.seg_len
    L = cfg.decode_max_len

    def run_stream():
        st = streaming_init(cfg.batch_size, cfg.beam_width, max_len=L,
                            device=dev)
        res = None
        for c in range(n_chunks):
            st, res = streaming_step(
                st, lp[c * chunk_frames:(c + 1) * chunk_frames],
                blank_id=cfg.blank_id)
        return res

    _log(f"warm-up streaming decode ({n_chunks} x {chunk_frames})")
    Timer.sync(run_stream())
    if iters is None:
        t0 = time.perf_counter()
        Timer.sync(run_stream())
        t_est = max(time.perf_counter() - t0, 1e-4)
        iters = min(100, max(3, math.ceil(1.0 / t_est)))
        _log(f"adaptive streaming iters: ~{t_est * 1e3:.1f} ms -> "
             f"{iters} x {reps} reps")
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = run_stream()
        Timer.sync(out)
        samples.append((time.perf_counter() - t0) / iters)
    return _spread_stats(samples)


def _degrade_mesh(cfg: Config) -> Config:
    """Presets may pin a mesh this host cannot build (conformer_l pins
    {'data': 2, 'model': 4}); the single-card bench degrades to no mesh
    with a warning instead of failing."""
    need = math.prod(cfg.mesh_shape.values())
    have = torch.cuda.device_count()
    if need > have:
        _log(f"WARNING: preset mesh_shape={cfg.mesh_shape} needs {need} "
             f"devices, have {have}; degrading to a single device")
        return dataclasses.replace(cfg, mesh_shape={})
    return cfg


def _device_line(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if device == "cpu":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for matmuls and cuDNN inside the block, then as before."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run_report(args):
    """Bench every model-family preset and the streaming row; write the
    table to gasr_tpu_torch/_build/RESULTS.md and print one JSON line."""
    from gasr_tpu_torch.runtime.flops import (device_peak_flops,
                                              model_fwd_flops)
    peak = device_peak_flops() if args.device == "cuda" else None
    rows = []
    for name in REPORT_PRESETS:
        cfg = _degrade_mesh(dataclasses.replace(PRESETS[name],
                                                device=args.device))
        _log(f"=== preset {name} (model={cfg.model}) ===")
        r = measure_ours(cfg, args.iters or 3, decode=not args.no_decode,
                         adaptive=args.iters is None)
        audio = cfg.batch_size * cfg.seg_len * FRAME_SHIFT_S
        flops = model_fwd_flops(cfg)
        mfu = (flops / r["forward_s"] / peak) if peak else None
        fs, ds = r["forward_stats"], r["decode_stats"]
        rows.append({
            "preset": name, "model": cfg.model,
            "batch": cfg.batch_size, "T": cfg.seg_len,
            "beam": cfg.beam_width,
            "dtype": cfg.compute_dtype,
            "forward_ms": round(r["forward_s"] * 1e3, 2),
            "forward_ms_range": [round(fs["min"] * 1e3, 2),
                                 round(fs["max"] * 1e3, 2)],
            "decode_ms": round(r["decode_s"] * 1e3, 2),
            "decode_ms_range": ([round(ds["min"] * 1e3, 2),
                                 round(ds["max"] * 1e3, 2)]
                                if ds else None),
            "reps": fs["reps"],
            "fwd_tflop": round(flops / 1e12, 3),
            "mfu_pct": round(mfu * 100, 1) if mfu is not None else None,
            "audio_s_per_s": round(audio / r["overall_s"], 1),
        })
    # the streaming row: the flagship decode in Tc=20 chunks
    scfg = dataclasses.replace(PRESETS["reference_large"],
                               device=args.device)
    _log("=== streaming (flagship decode, Tc=20 chunks) ===")
    st = measure_streaming(scfg, chunk_frames=20, iters=args.iters)
    audio = scfg.batch_size * scfg.seg_len * FRAME_SHIFT_S
    rows.append({
        "preset": "streaming_Tc20", "model": scfg.model,
        "batch": scfg.batch_size, "T": scfg.seg_len,
        "beam": scfg.beam_width, "dtype": scfg.compute_dtype,
        "forward_ms": 0.0, "forward_ms_range": None,
        "decode_ms": round(st["median"] * 1e3, 2),
        "decode_ms_range": [round(st["min"] * 1e3, 2),
                            round(st["max"] * 1e3, 2)],
        "reps": st["reps"], "fwd_tflop": None, "mfu_pct": None,
        "audio_s_per_s": round(audio / st["median"], 1),
    })
    # the training rows: ms a step (in the forward column), MFU against
    # the 3x-forward count, peak memory and the step's split; float32
    # GEMMs and convolutions (the flagship, the backward of conv_mixed's
    # float32 twin) in float32, TF32 off as chip_smoke.py runs them
    from gasr_tpu_torch.runtime.flops import model_train_flops
    for row_name, preset, cd_override in TRAIN_ROWS:
        tcfg = _degrade_mesh(dataclasses.replace(PRESETS[preset],
                                                 device=args.device))
        _log(f"=== {row_name} (model={tcfg.model}) ===")
        with _tf32_off():
            tf32 = (f"matmul.allow_tf32="
                    f"{torch.backends.cuda.matmul.allow_tf32}, "
                    f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
            ts = measure_train(tcfg, iters=args.iters,
                               compute_dtype=cd_override)
            split = (measure_train_split(tcfg, compute_dtype=cd_override)
                     if args.device == "cuda" else None)
        tflops = model_train_flops(tcfg)
        tmfu = (tflops / ts["median"] / peak) if peak else None
        audio = tcfg.batch_size * tcfg.seg_len * FRAME_SHIFT_S
        rows.append({
            "preset": row_name, "model": tcfg.model,
            "batch": tcfg.batch_size, "T": tcfg.seg_len, "beam": None,
            "dtype": cd_override or tcfg.compute_dtype,
            "forward_ms": round(ts["median"] * 1e3, 2),
            "forward_ms_range": [round(ts["min"] * 1e3, 2),
                                 round(ts["max"] * 1e3, 2)],
            "decode_ms": None, "decode_ms_range": None,
            "reps": ts["reps"],
            "fwd_tflop": round(tflops / 1e12, 3),
            "mfu_pct": round(tmfu * 100, 1) if tmfu is not None else None,
            "audio_s_per_s": round(audio / ts["median"], 1),
            "peak_gb": (round(ts["peak_bytes"] / 1e9, 2)
                        if ts["peak_bytes"] is not None else None),
            "split_ms": ({k: round(v, 2) for k, v in split.items()}
                         if split else None),
            "loss_first_last": [ts["losses"][0], ts["losses"][-1]],
            "tf32": tf32,
        })
    lines = [
        "# Benchmark results of the PyTorch port (per-iteration medians "
        "+- spread)", "",
        f"Device: {_device_line(args.device)}", "",
        "Protocol: `python -m gasr_tpu_torch.bench --report`; iterations",
        "per preset are sized so that each timed loop covers ~1 s (host",
        "clock, one device fence at the loop's end), and every preset runs",
        "5 timed loops: the table gives the MEDIAN with the [min, max]",
        "range. MFU = analytic forward FLOPs / median forward time / the",
        "card's dense bf16 peak (runtime/flops.py), for the float32",
        "presets too, whose MFU therefore reads low. The streaming row",
        "times the flagship decode fed in Tc=20 chunks (beam and prefix",
        "state carried across streaming_step calls; no forward column).",
        "train_* rows time the training step (forward + CTC loss + backward",
        "+ clip + AdamW, params updated in place) on one fixed batch: their",
        "fwd column is ms a STEP and MFU is against the 3x-forward count;",
        "peak memory, the step's split (CUDA events) and the TF32 settings",
        "follow the table.",
        "",
        "| preset | model | B | T | beam | dtype | fwd ms [min,max] | "
        "decode ms [min,max] | TFLOP | MFU% | audio-s/s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def _rng(med, rng):
        if med is None:
            return "-"
        if rng is None:
            return f"{med}"
        return f"{med} [{rng[0]}, {rng[1]}]"

    for r in rows:
        lines.append(
            f"| {r['preset']} | {r['model']} | {r['batch']} | {r['T']} | "
            f"{r['beam'] if r['beam'] is not None else '-'} | "
            f"{r['dtype']} | "
            f"{_rng(r['forward_ms'], r['forward_ms_range'])} | "
            f"{_rng(r['decode_ms'], r['decode_ms_range'])} | "
            f"{r['fwd_tflop'] if r['fwd_tflop'] is not None else '-'} | "
            f"{r['mfu_pct'] if r['mfu_pct'] is not None else '-'} | "
            f"{r['audio_s_per_s']} |")
    for r in rows:
        if "split_ms" in r:
            lines.append(f"- {r['preset']}: peak {r['peak_gb']} GB, split "
                         f"{r['split_ms']} ms, loss {r['loss_first_last']}"
                         f" (first, last step), {r['tf32']}")
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "RESULTS.md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps({"metric": "report", "rows": rows}))


SCALING_COUNTS = (1, 2, 4, 8, 16, 32)      # card counts measured, as JAX's
PROJECTED_COUNTS = (1, 2, 4)               # the counts NVLINK_ALLREDUCE_B_S
                                           # was measured over


def run_scaling(args):
    """Weak-scaling artifact, the JAX package's `bench.py --scaling`, into
    gasr_tpu_torch/_build/SCALING.json and one JSON line.

    With 2 or more cards: `measure_dp_scaling` of reference_large (B=256
    a card, T=200, H=2048; forward and decode) over 1, 2, 4, ... cards,
    one rank a card ("mode": "measured"), and the NCCL all-reduce rate of
    its bf16 gradient bytes over every card. With one card: the analytic
    projection (`analytic_dp_projection`) seeded by `measure_ours` on the
    card, at the all-reduce rate measured over 4 cards
    (`scaling.NVLINK_ALLREDUCE_B_S`), with the gloo protocol check (the DP
    program on 1 and 2 CPU ranks) and `measure_fixed_work_virtual`
    ("mode": "analytic_projection"). The metric's name says which:
    dp_weak_scaling_efficiency[_projected]. The host's CPU count is
    recorded: the ranks' host work shares it."""
    from gasr_tpu_torch.parallel import scaling
    resolve_device(args.device)
    if args.device != "cuda":
        raise ValueError("--scaling measures cards; it has no --device cpu")
    cards = torch.cuda.device_count()
    cfg = dataclasses.replace(PRESETS["reference_large"], device="cuda")
    grad_bytes = scaling.param_bytes(cfg, 2)
    result = {"backend": "cuda", "n_devices": cards,
              "card": _device_line("cuda"), "host_cpus": os.cpu_count(),
              "per_device_batch": cfg.batch_size,
              "gradient_bytes": grad_bytes}
    if cards >= 2:
        counts = [n for n in SCALING_COUNTS if n <= cards]
        rows = scaling.measure_dp_scaling(cfg, counts, iters=args.iters or 3,
                                          decode=True)
        result.update(mode="measured", rows=rows,
                      allreduce=scaling.measure_allreduce_bandwidth(
                          cards, grad_bytes))
    else:
        step_s = measure_ours(cfg, args.iters or 10, decode=True,
                              reps=3)["overall_s"]
        rows = scaling.analytic_dp_projection(
            cfg, list(PROJECTED_COUNTS), step_s, scaling.NVLINK_ALLREDUCE_B_S)
        small = Config(batch_size=4, linear_size=64, rnn_hidden_size=64,
                       seg_len=20, beam_width=4, device="cpu")
        proto = scaling.measure_dp_scaling(small, [1, 2], iters=2)
        result.update(
            mode="analytic_projection", step_s_measured_1chip=step_s,
            step_seed="measure_ours on this card, this run",
            model=("ring all-reduce 2(n-1)/n * bytes/bw, bw the NCCL "
                   "all-reduce rate measured over 4 cards of one host; 80% "
                   "overlapped behind compute"),
            rows=rows,
            protocol_check={"ran": True, "ok": len(proto) == 2 and all(
                math.isfinite(r["iter_s"]) for r in proto)},
            measured_virtual=scaling.measure_fixed_work_virtual(),
            caveat=("1 card: the n-card rows are an analytic ring model "
                    "seeded by the measured single-card step; the gloo "
                    "CPU run checks the DP program only"))
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "SCALING.json", "w") as f:
        json.dump(result, f, indent=1)
    metric = ("dp_weak_scaling_efficiency" if result["mode"] == "measured"
              else "dp_weak_scaling_efficiency_projected")
    print(json.dumps({"metric": metric,
                      "value": rows[-1]["efficiency"] if rows else None,
                      "unit": "fraction", "vs_baseline": None,
                      "detail": result}))


def fault_drill(device: str) -> dict:
    """Corrupt log-probs with a NaN and check that assert_finite fires."""
    from gasr_tpu_torch.runtime.validation import (NumericsError,
                                                   assert_finite,
                                                   inject_fault)
    lp = torch.zeros((4, 2, 3), device=resolve_device(device))
    bad = inject_fault(lp, "nan")
    try:
        assert_finite(bad, "logits")
    except NumericsError as e:
        return {"fault_injection": "detected", "error": str(e)}
    raise SystemExit("fault went UNDETECTED")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="reduced workload for smoke testing")
    ap.add_argument("--no-decode", action="store_true")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--baseline-iters", type=int, default=2)
    ap.add_argument("--fault-inject", action="store_true",
                    help="failure-detection drill: corrupt logits with "
                         "NaN and verify assert_finite fires")
    ap.add_argument("--config", default=None,
                    help="bench a named preset from gasr_tpu_torch.config."
                         "PRESETS")
    ap.add_argument("--report", action="store_true",
                    help="bench all model-family presets -> "
                         "gasr_tpu_torch/_build/RESULTS.md")
    ap.add_argument("--scaling", action="store_true",
                    help="weak-scaling efficiency protocol -> "
                         "gasr_tpu_torch/_build/SCALING.json (cards only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs (default: the card)")
    args = ap.parse_args()

    if args.scaling:
        run_scaling(args)
        return

    if args.fault_inject:
        print(json.dumps(fault_drill(args.device)))
        return

    if args.config:
        cfg = PRESETS[args.config]
    elif args.small:
        cfg = Config(batch_size=8, linear_size=256, rnn_hidden_size=256,
                     seg_len=50, beam_width=10, epoch=3)
    else:
        cfg = Config()  # flagship: reference config shapes
    cfg = dataclasses.replace(cfg, device=args.device)
    iters = args.iters or cfg.epoch

    if args.report:
        run_report(args)
        return

    ours = measure_ours(cfg, iters, decode=not args.no_decode)
    base = measure_torch_baseline(
        cfg, args.baseline_iters,
        BUILD / ("bench_baseline.json" + (".small" if args.small else "")))

    audio_s_per_iter = cfg.batch_size * cfg.seg_len * FRAME_SHIFT_S
    value = audio_s_per_iter / ours["overall_s"]
    vs = (base["overall_s"] / ours["overall_s"]) if base else None

    detail = {"ours": ours, "baseline": base,
              "config": {"batch_size": cfg.batch_size,
                         "seg_len": cfg.seg_len,
                         "hidden": cfg.rnn_hidden_size,
                         "beam_width": cfg.beam_width,
                         "rnn_impl": cfg.rnn_impl},
              "device": _device_line(args.device),
              "rtf_per_chip": value}
    print(json.dumps({
        "metric": "audio-seconds/s/chip (fwd+beam decode)",
        "value": round(value, 2),
        "unit": "audio_s/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
