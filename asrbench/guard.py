"""The check that nothing loaded is JAX or the JAX package, and that no
process the run started outlives its result.

Modules are compared by their whole top-level name (the part before the
first dot), so `gasr_tpu_torch`, the port, passes and `gasr_tpu` does
not.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "gasr_tpu")
PROGRAM = "gasr_tpu_torch"


def top_names(modules: Iterable[str]) -> set:
    return {name.split(".", 1)[0] for name in modules}


def found(modules: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """The forbidden top-level names among `modules` (default: every
    module loaded in this process)."""
    names = top_names(sys.modules if modules is None else modules)
    return sorted(n for n in forbidden if n in names)


def check(where: str) -> None:
    """Raise SystemExit(3), naming what was found on standard error,
    where a forbidden module is loaded."""
    bad = found()
    if bad:
        print(f"asrbench: {where}: forbidden modules loaded: "
              f"{', '.join(bad)}", file=sys.stderr, flush=True)
        raise SystemExit(3)


def children() -> List[int]:
    """The processes this one started that still run (Linux's /proc: its
    children that are not zombies)."""
    kids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(") ", 1)[1].split()[:2]
        except (FileNotFoundError, ProcessLookupError):
            continue                            # ended while we looked
        if int(ppid) == os.getpid() and state != "Z":
            kids.append(int(pid))
    return kids


def check_children(where: str) -> None:
    """Raise SystemExit(3), naming them on standard error, where a
    process this one started still runs."""
    kids = children()
    if kids:
        print(f"asrbench: {where}: processes still running: "
              f"{', '.join(map(str, kids))}", file=sys.stderr, flush=True)
        raise SystemExit(3)
