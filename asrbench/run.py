"""The benchmark's command: one run of one cell on the cards it asks for.

    python3 -m asrbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics untraced, its
per-layer metrics traced), `device`, `breakdown` (traced) and `checks`
(each number compared, with its limit), and the same numbers as the last
lines of standard error. Exits 2, printing no result, without a CUDA
card (or with fewer than the cell asks for), and 3 where JAX or the JAX
package is loaded, or a process it started still runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Compiler caches at fixed paths inside the checkout, so that only a
    checkout's first run builds."""
    cache = ROOT / ".asrbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    from asrbench import guard, harness
    from asrbench.manifest import load_cell

    guard.check("at start")
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("asrbench: no CUDA card; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"asrbench: {cell.name} needs {cell.chips} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, log)
    guard.check("before the result")
    guard.check_children("before the result")
    result["device"]["power_limit"] = _power_limit()
    checks = result.pop("checks")
    result["checks"] = checks                      # the last key
    harness.print_checks(checks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
