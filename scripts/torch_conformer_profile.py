#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's conformer_l serving path, on
one CUDA card.

    python3 scripts/torch_conformer_profile.py

Drives the conformer_l preset (d=512, 17 blocks, 8 heads, B=64, T=1200,
F=80, V=129, beam 16, bf16 compute, mesh_shape={}) as bench.py does:
`model_apply(..., compute_dtype="bfloat16")` then `ctc_beam_search`.
Prints, with the card's name and power limit:
  - each stage's time on CUDA events (mean of 3 after a warm-up): the stem,
    one block and its parts (half FFN, attention, conv module), the output
    projection with log_softmax, the decode;
  - a torch.profiler trace of one forward + decode: device time by kernel
    family (by kernel name), and the device's busy share: that device
    time over the host-clock time of the same work run without the
    profiler (median of 3, synchronised around each).
Imports nothing of JAX. Needs a card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    from gasr_tpu_torch.config import PRESETS
    from gasr_tpu_torch.decoder.beam_search import ctc_beam_search
    from gasr_tpu_torch.models import conformer as conf
    from gasr_tpu_torch.models import model_apply, model_init
    from gasr_tpu_torch.ops.attention import mhsa_rel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(PRESETS["conformer_l"], mesh_shape={})
    params = model_init(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(cfg.batch_size, cfg.seg_len, cfg.feat_size)).astype(
        np.float32)).to(dev)
    bf = torch.bfloat16

    def cuda_ms(fn, iters=3):
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

    def forward():
        return model_apply(cfg, params, x, compute_dtype="bfloat16")

    def decode(lp):
        return ctc_beam_search(lp, beam_width=cfg.beam_width,
                               max_len=cfg.decode_max_len)

    hp = conf._preset(cfg)
    heads, K = hp["num_heads"], hp["conv_kernel"]
    with torch.no_grad():
        lp = forward()
        stem_out = conf._lin(params["sub_proj"], conf.conv2d(
            params["sub2"], conf.conv2d(params["sub1"], x[..., None], (2, 2),
                                        compute_dtype=bf), (2, 2),
            compute_dtype=bf).flatten(2), bf).transpose(0, 1)
        blk = params["blocks"][0]
        h = stem_out
        stages = {
            "forward (whole)": forward,
            "stem (conv1 + conv2 + sub_proj)": lambda: conf._lin(
                params["sub_proj"], conf.conv2d(
                    params["sub2"], conf.conv2d(
                        params["sub1"], x[..., None], (2, 2),
                        compute_dtype=bf), (2, 2), compute_dtype=bf
                ).flatten(2), bf),
            "one block": lambda: conf._block(blk, h, heads, K, None, bf),
            "  half FFN": lambda: conf._ffn(blk["ff1"], h, bf),
            "  attention (LN + mhsa_rel, flash kernel)": lambda: mhsa_rel(
                blk["mhsa"], conf._ln(blk["mhsa_ln"], h), heads,
                compute_dtype=bf),
            "  attention, attn_impl='xla'": lambda: mhsa_rel(
                blk["mhsa"], conf._ln(blk["mhsa_ln"], h), heads,
                compute_dtype=bf, impl="xla"),
            "  conv module": lambda: conf._convmod(blk["conv"], h, K, bf),
            "proj + log_softmax": lambda: torch.log_softmax(conf.linear(
                params["proj"], h, None, bf), dim=-1),
            "decode (W=16, max_len 256)": lambda: decode(lp),
        }
        for name, fn in stages.items():
            print(f"{name}: {cuda_ms(fn):.3f} ms", flush=True)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(forward())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = sorted(walls)[1]

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode(forward())
            torch.cuda.synchronize()
    families = {}
    total_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0.0) or 0.0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = ev.key.lower()
        fam = ("flash_mhsa_rel kernel" if "flash_mhsa" in n
               else "fused decode / traceback kernels" if
               ("prefix_decode" in n or "traceback" in n)
               else "convolution (cuDNN, depthwise)" if (
                   "conv" in n or "fprop" in n or "implicit" in n
                   or "winograd" in n)
               else "GEMM (cuBLAS)" if ("gemm" in n or "xmma" in n
                                        or "cutlass" in n or "nvjet" in n)
               else "copies" if ("copy" in n or "memcpy" in n
                                 or "memset" in n)
               else "reductions / softmax" if ("reduce" in n
                                               or "softmax" in n)
               else "elementwise" if "elementwise" in n
               else "other")
        families[fam] = families.get(fam, 0.0) + dev_us
        total_us += dev_us
    if total_us == 0:
        print("profiler: no device time recorded", flush=True)
        return 0
    print(f"profiled forward + decode: device time {total_us / 1e3:.3f} ms; "
          f"the same work unprofiled {wall_ms:.3f} ms on the host clock "
          f"(median of 3): busy share {total_us / 1e3 / wall_ms:.3f} on "
          f"{card}", flush=True)
    for fam, us in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {fam}: {us / 1e3:.3f} ms ({us / total_us:.3f})")
    print("top kernels by device time:")
    rows = sorted((ev for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda ev: -(getattr(ev, "device_time_total", 0.0)
                                   or 0.0))[:12]
    for ev in rows:
        print(f"  {ev.device_time_total / 1e3:9.3f} ms  x{ev.count:<5d} "
              f"{ev.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
