#!/usr/bin/env python3
"""Where the sharded train step's time goes, one process a card.

    python3 scripts/torch_sharded_split.py [--steps 3]

Runs `train.make_sharded_train_step` on reference_large at full width
(float32, B=256 in all, T=200, H=2048; one fixed `synthetic_batch`; TF32
off) on the meshes that the cards present allow: {"data": 1, "model": 1}
on one card, then {"data": 4, "model": 1}, {"data": 1, "model": 4} and
{"data": 2, "model": 2} with 4 cards. For each it prints every rank's
host time a step (the steps between barriers and a device fence) and the
step's split by CUDA events recorded as each phase ends (the step's
`mark`: forward, CTC loss, backward, the grads' all-reduce over "data",
clip + AdamW), means over `--steps` steps after one warm-up step. Device
time between events, so a phase that the host holds back counts its
waits. Then one JSON line with every number.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("forward", "ctc", "backward", "allreduce", "optimizer")


def split_run(config, mesh_shape, batch, steps):
    """One rank's side: the split of `steps` sharded steps."""
    import torch
    from gasr_tpu_torch.parallel.distributed import global_mesh
    from gasr_tpu_torch.parallel.sharding import batch_specs, shard_tree
    from gasr_tpu_torch.train import make_sharded_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = global_mesh(mesh_shape)
    step, params, state = make_sharded_train_step(config, mesh)
    local = shard_tree(batch, batch_specs(), mesh)
    totals = dict.fromkeys(PHASES, 0.0)
    host = 0.0
    for i in range(steps + 1):
        events = {}

        def mark(phase):
            events[phase] = torch.cuda.Event(enable_timing=True)
            events[phase].record()

        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        params, state, _ = step(params, state, local, mark=mark)
        events["optimizer"].synchronize()
        if i:
            host += time.perf_counter() - t0
            prev = events["start"]
            for phase in PHASES:
                totals[phase] += prev.elapsed_time(events[phase])
                prev = events[phase]
    return {"host_ms": host / steps * 1e3,
            "split_ms": {p: t / steps for p, t in totals.items()}}


def main():
    import torch
    from gasr_tpu_torch.config import PRESETS
    from gasr_tpu_torch.parallel.distributed import spawn
    from gasr_tpu_torch.train import synthetic_batch
    # the ranks import the function by its module's name ("__main__" names
    # no module there)
    from scripts.torch_sharded_split import split_run as rank_fn
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cards = torch.cuda.device_count()
    cfg = dataclasses.replace(PRESETS["reference_large"], device="cpu")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(0))
    meshes = [{"data": 1, "model": 1}]
    if cards >= 4:
        meshes += [{"data": 4, "model": 1}, {"data": 1, "model": 4},
                   {"data": 2, "model": 2}]
    out = {"card": card, "cards": cards, "host_cpus": os.cpu_count(),
           "rows": []}
    for shape in meshes:
        world = shape["data"] * shape["model"]
        ranks = spawn(rank_fn, world, "cuda", cfg, shape, batch,
                      args.steps)
        out["rows"].append({"mesh": shape, "ranks": ranks})
        for r, res in enumerate(ranks):
            print(f"{shape} rank {r} on {card}: {res['host_ms']:.3f} ms a "
                  f"step (host clock); split " + ", ".join(
                      f"{p} {v:.3f}" for p, v in res["split_ms"].items())
                  + " ms (CUDA events)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
