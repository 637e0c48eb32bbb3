"""Scaling harness: data-parallel weak scaling measured across cards,
and an analytic projection where only one card is present. The port of
`gasr_tpu/parallel/scaling.py`.

Protocol (BASELINE.md): audio-seconds/s at 1 card and at n, with
efficiency = throughput(n) / (n * throughput(1)). `measure_dp_scaling`
runs one rank per card, each with the per-card batch. With one card,
`analytic_dp_projection` prices the gradient all-reduce of a ring over
n cards from a measured single-card step; its link rate is an argument
(`measure_allreduce_bandwidth` measures it where there are cards to
measure). `measure_fixed_work_virtual` runs the same global batch on 1
and on n gloo ranks on this host's CPU, which checks the sharded
program's overhead and not the cards.

No link constant of the JAX module carries over (those are a TPU's).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.decoder import ctc_beam_search
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.ops.cuda import _lib, launch_counts
from gasr_tpu_torch.parallel.distributed import rank_device, spawn
from gasr_tpu_torch.runtime._tree import tensors
from gasr_tpu_torch.runtime.timer import Timer
from gasr_tpu_torch.train import sharded_train_run, synthetic_batch

FRAME_SHIFT_S = 0.01

# The bus rate of an NCCL all-reduce of the flagship's bf16 gradient bytes
# (42,479,710) over 4 cards of one host, 2(n-1)/n * bytes / t, t the
# slowest rank's mean of 20 calls: measured by `measure_allreduce_bandwidth`
# on 4 x NVIDIA H100 80GB HBM3 at 700.00 W (NVLink, 32 host CPUs),
# 2026-10-17: the link rate to give `analytic_dp_projection` (`bw_b_s`)
# where fewer cards are present.
NVLINK_ALLREDUCE_B_S = 265.2126e9


def param_bytes(config: Config, dtype_bytes: int = 4) -> int:
    """Total model parameter bytes (the grads all-reduced each DP step)."""
    params = model_init(config, torch.Generator().manual_seed(0),
                        device="cpu")
    return sum(t.numel() for t in tensors(params)) * dtype_bytes


def analytic_dp_projection(config: Config, counts: List[int],
                           step_s: float, bw_b_s: float,
                           grad_dtype_bytes: int = 2,
                           overlap: float = 0.8) -> List[Dict]:
    """Roofline DP weak-scaling projection (JAX's, its link rate an
    argument).

    step_s: the MEASURED single-card time of one step at the per-card
    batch (the compute term). Communication: a ring all-reduce of the
    gradient bytes, 2 (n - 1) / n * bytes / bw_b_s, `overlap` of it hidden
    behind compute (JAX's 0.8: layer k's all-reduce can run during the
    backward of layers k-1..0, and only the first layer's grads have
    nothing left to hide behind). Every row also carries
    `efficiency_overlap0`, the efficiency with nothing hidden.
    """
    bytes_ar = param_bytes(config, grad_dtype_bytes)
    rows = []
    for n in counts:
        t_comm = 0.0 if n <= 1 else 2.0 * (n - 1) / n * bytes_ar / bw_b_s
        exposed = t_comm * (1.0 - overlap)
        t_step = step_s + exposed
        audio = config.batch_size * n * config.seg_len * FRAME_SHIFT_S
        rows.append({
            "devices": n, "global_batch": config.batch_size * n,
            "iter_s": t_step,
            "audio_s_per_s": audio / t_step,
            "t_comm_raw_ms": t_comm * 1e3,
            "t_comm_exposed_ms": exposed * 1e3,
            "link_b_s": bw_b_s,
            "efficiency": step_s / t_step,
            "efficiency_overlap0": step_s / (step_s + t_comm),
        })
    return rows


def _barrier_timed(fn, iters: int) -> float:
    """Seconds a call of fn over `iters` calls, the loop between barriers
    and ended by a device fence."""
    dist.barrier()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    Timer.sync(out)
    dist.barrier()
    return (time.perf_counter() - t0) / iters


def allreduce_run(nbytes: int, iters: int) -> Dict[str, float]:
    """One rank's side of `measure_allreduce_bandwidth`: all-reduces of a
    bf16 buffer of `nbytes` over the world, timed after one warm-up."""
    dev = rank_device()
    buf = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)

    def reduce():
        dist.all_reduce(buf)
        return buf

    reduce()
    return {"s": _barrier_timed(reduce, iters)}


def measure_allreduce_bandwidth(n: int, nbytes: int, device: str = "cuda",
                                iters: int = 20) -> Dict[str, float]:
    """The bus rate of an all-reduce of `nbytes` over n ranks (n cards with
    NCCL, or gloo processes on the CPU): 2 (n - 1) / n * nbytes / t, the
    rate that `analytic_dp_projection`'s ring model takes; t is the
    slowest rank's time a call."""
    if n < 2:
        raise ValueError("an all-reduce over one rank moves nothing")
    t = max(r["s"] for r in spawn(allreduce_run, n, device, nbytes, iters))
    return {"ranks": n, "bytes": nbytes, "s": t,
            "bus_b_s": 2.0 * (n - 1) / n * nbytes / t}


def dp_run(config: Config, iters: int, decode: bool) -> Dict:
    """One rank's side of `measure_dp_scaling`: the forward (and decode)
    of its own batch (config.batch_size utterances, uniform inputs drawn
    from seed 1 + rank; params from seed 0, alike on every rank), one
    warm-up call, then `iters` calls between barriers. Returns the time a
    call and the kernel launches of those calls."""
    dev = rank_device()
    params = model_init(config, torch.Generator().manual_seed(0),
                        device=dev.type)
    x = torch.rand((config.batch_size, config.seg_len, config.feat_size),
                   generator=torch.Generator().manual_seed(
                       1 + dist.get_rank())).to(dev)

    def run():
        with torch.no_grad():
            lp = model_apply(config, params, x)
        if decode:
            return ctc_beam_search(lp, beam_width=config.beam_width,
                                   max_len=config.decode_max_len)
        return lp

    Timer.sync(run())
    before = launch_counts()
    s = _barrier_timed(run, iters)
    after = launch_counts()
    return {"iter_s": s, "calls": iters,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}


def measure_dp_scaling(config: Config, device_counts: List[int],
                       iters: int = 3, decode: bool = False) -> List[Dict]:
    """Data-parallel forward (+ decode) throughput against the number of
    cards, weak scaling: one rank per card (gloo processes with
    config.device="cpu", at most one a core), config.batch_size
    utterances a rank. A count past the cards present is left out, as JAX
    leaves out one past its devices. Each row: devices, global batch,
    iter_s (the slowest rank's time a call), audio-seconds/s over every
    rank, efficiency against the first row's per-rank rate, and each
    rank's kernel launches over its timed calls."""
    if config.device == "cuda":
        _lib.build_all()            # once here, not in every rank
        present = torch.cuda.device_count()
    else:
        present = os.cpu_count() or 1          # a gloo rank a core
    results = []
    for n in device_counts:
        if n > present:
            continue
        ranks = spawn(dp_run, n, config.device, config, iters, decode)
        dt = max(r["iter_s"] for r in ranks)
        B = config.batch_size * n
        results.append({"devices": n, "global_batch": B, "iter_s": dt,
                        "audio_s_per_s": B * config.seg_len * FRAME_SHIFT_S
                        / dt,
                        "calls": iters,
                        "launches": [r["launches"] for r in ranks]})
    if results:
        base = results[0]["audio_s_per_s"] / results[0]["devices"]
        for r in results:
            r["efficiency"] = r["audio_s_per_s"] / (r["devices"] * base)
    return results


def fixed_work_run(config: Config, batch: Dict[str, torch.Tensor],
                   iters: int) -> Dict:
    """One rank's side of `measure_fixed_work_virtual`: the DP train step
    ({"data": world, "model": 1}) on this rank's share of `batch`."""
    run = sharded_train_run(config, {"data": -1, "model": 1}, batch,
                            timed_steps=iters)
    return {"s": run["ms_per_step"] / 1e3}


def measure_fixed_work_virtual(config: Optional[Config] = None,
                               n_hi: int = 4, iters: int = 5) -> Dict:
    """Strong scaling on the host's CPU: the same global batch on 1 gloo
    rank and on n_hi, the host's cores divided among the ranks, the DP
    train step timed on each. The same operations on the same cores, so
    any slowdown is the sharded program's overhead and its gradient
    all-reduce (predicted ~1.0, JAX's tolerance 0.25). A check of the
    harness, not of the cards."""
    cfg = config or Config(batch_size=32, linear_size=128,
                           rnn_hidden_size=128, seg_len=64, beam_width=4,
                           vocab_size=28, device="cpu")
    if cfg.batch_size % n_hi:
        raise ValueError(f"batch {cfg.batch_size} does not split over "
                         f"{n_hi} ranks")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
    cores = os.cpu_count() or 1
    times = {}
    for n in (1, n_hi):
        ranks = spawn(fixed_work_run, n, "cpu", cfg, batch, iters,
                      threads=max(1, cores // n))
        times[n] = max(r["s"] for r in ranks)
    eff = times[1] / times[n_hi]
    return {
        "protocol": ("fixed total work (strong scaling): same global "
                     "batch + same host cores on 1 gloo rank vs "
                     f"{n_hi}; efficiency = t(1)/t({n_hi})"),
        "global_batch": cfg.batch_size,
        "host_cpus": cores,
        "t_1dev_s": times[1],
        "t_ndev_s": times[n_hi],
        "n_hi": n_hi,
        "efficiency_measured": eff,
        "analytic_predicted": 1.0,
        "tolerance": 0.25,
        "within_tolerance": bool(abs(eff - 1.0) <= 0.25),
    }
