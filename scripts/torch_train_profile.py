#!/usr/bin/env python3
"""Where the time goes in a training step of the PyTorch port, on one CUDA
card: the bench's two training rows (`gasr_tpu_torch.bench.TRAIN_ROWS`:
reference_large float32, conformer_l bf16 with mesh_shape={}).

    python3 scripts/torch_train_profile.py

For each row, after two warm-up steps on one fixed batch (TF32 off, as
chip_smoke.py runs):
  - the step's host-clock time (median of 3, synchronised around each);
  - a torch.profiler trace of one step: device time by kernel family (by
    kernel name), the kernel launches, and the device's busy share (that
    device time over the host-clock step time);
  - the CTC loss alone at the row's log-prob shape (`train.batch_loss`
    on the batch's labels): forward, and forward + backward to the
    log-probs, host clock around synchronised calls (median of 5).
Prints the card's name and power limit beside them. Imports nothing of
JAX. Needs a card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def family(name: str) -> str:
    n = name.lower()
    if "flash_mhsa" in n:
        return "flash_mhsa_rel kernel"
    if "stem_" in n:
        return "fused stem kernels"
    if "conv" in n or "fprop" in n or "dgrad" in n or "wgrad" in n \
            or "implicit" in n or "winograd" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "xmma" in n or "cutlass" in n or "nvjet" in n \
            or "splitk" in n:
        return "GEMM (cuBLAS)"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (foreach)"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copies"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reductions / softmax"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from gasr_tpu_torch import bench
    from gasr_tpu_torch.config import PRESETS
    from gasr_tpu_torch.models import CONFORMERS
    from gasr_tpu_torch.models.conformer import conformer_output_length
    from gasr_tpu_torch.train import batch_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    for row, preset, cd in bench.TRAIN_ROWS:
        cfg = bench._degrade_mesh(PRESETS[preset])
        params, state, step, batch = bench._train_setup(cfg, cd)

        def run():
            nonlocal params, state
            params, state, m = step(params, state, batch)
            return m

        for _ in range(2):
            run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[1]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        fams, n_kernels, total = {}, 0, 0.0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = ev.device_time_total if hasattr(
                ev, "device_time_total") else ev.cuda_time_total
            if not us:
                continue
            fam = family(ev.name)
            fams[fam] = fams.get(fam, 0.0) + us / 1e3
            total += us / 1e3
            n_kernels += 1
        print(f"{row} ({preset}, {cd or cfg.compute_dtype}) on {card}: step "
              f"{wall:.3f} ms (host clock, median of 3); device time "
              f"{total:.3f} ms in {n_kernels} kernels, busy share "
              f"{total / wall:.3f}", flush=True)
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"  {fam}: {ms:.3f} ms ({100 * ms / total:.1f}%)",
                  flush=True)
        T_out = (conformer_output_length(cfg.seg_len)
                 if cfg.model in CONFORMERS else cfg.seg_len)
        gen = torch.Generator(device="cuda").manual_seed(0)
        lp = torch.randn((T_out, cfg.batch_size, cfg.output_size),
                         generator=gen, device="cuda").log_softmax(-1)
        lp.requires_grad_()

        def host_ms(fn):
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times[1:])[2]

        ctc_f = host_ms(lambda: batch_loss(lp, batch, cfg.blank_id))
        ctc_fb = host_ms(lambda: torch.autograd.grad(
            batch_loss(lp, batch, cfg.blank_id), lp))
        print(f"  CTC loss alone [{T_out}, {cfg.batch_size}, "
              f"{cfg.output_size}], labels of {batch['labels'].shape[1]}: "
              f"forward {ctc_f:.3f} ms, forward + backward {ctc_fb:.3f} ms "
              f"(host clock, median of 5)", flush=True)
        del params, state, step, batch, lp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
