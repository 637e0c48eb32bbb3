"""Readings that the limits of `correct` are set from, on the card, in one
process:

    python3 -m asrbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

For each of `--seeds`, a whole run of the cell and the numbers its
comparison gives; where the seed is also among `--control-seeds`, the
numbers the control gives in the program's place on the same weights,
inputs and (training) the state the program began its last step with;
where among `--fault-seeds`, the numbers of each fault the loop plants
in the reference in the program's place (training: half of each batch
left out, the mean over the rest; data-parallel training also one
rank's shard left out, and the exchange left out). One JSON line each;
the benchmark's own runs never run this. A cell of more than one card
runs each seed in a process of its own (this command, one seed at a
time), since NCCL's group is joined once a process.
"""

import json
import subprocess
import sys


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from asrbench.run import _cache_dirs
    _cache_dirs()
    import torch

    from asrbench import guard, harness
    from asrbench.manifest import load_cell

    guard.check("at start")
    cell = load_cell(args.workload)
    if cell.chips > 1 and len(args.seeds) > 1:
        def only(seeds, seed):
            return ",".join(str(s) for s in seeds if s == seed)
        codes = [subprocess.run(
            [sys.executable, "-m", "asrbench.calibrate", "--workload",
             args.workload, "--seeds", str(seed), "--control-seeds",
             only(args.control_seeds, seed), "--fault-seeds",
             only(args.fault_seeds, seed), "--seconds", str(args.seconds),
             "--device", args.device]).returncode for seed in args.seeds]
        return max(codes)

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in args.seeds:
        def after(load, params, seed=seed):
            if seed in args.control_seeds:
                emit(side="control", seed=seed,
                     numbers=load.control_numbers(params))
            if seed in args.fault_seeds:
                for name, vals in load.fault_numbers(params).items():
                    emit(side=f"fault_{name}", seed=seed, numbers=vals)
        res = harness.run(cell, seed, args.seconds, False, args.device,
                          log=log, after=after)
        emit(side="program", seed=seed, correct=res["correct"],
             numbers=dict({k: v["value"] for k, v in res["checks"].items()},
                          **res.get("readings", {})),
             metrics=res["metrics"],
             peak=res["device"]["memory_peak_bytes"])
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
