"""Multi-process bring-up: one process (rank) per card, the port's
counterpart of `gasr_tpu/parallel/distributed.py`.

JAX drives every chip of a host from one process, and GSPMD inserts the
collectives that its sharding annotations imply. The port runs one
process per card, joined by `torch.distributed`: NCCL between cards,
gloo between CPU processes (the tests). Each rank holds its own shards
and issues its own kernels, so the host work of a step (the CTC loss's
eager loop paces a training step) runs in parallel across cards rather
than on one thread for all of them.

  initialize()               -> torch.distributed.init_process_group from
                                the variables `torchrun` sets; a no-op
                                without them
  global_mesh(shape)         -> a DeviceMesh over every rank, with
                                `make_mesh`'s sizing rule
  host_local_batch_to_global -> this rank's share of the batch on its
                                device (the global batch is never
                                materialized)
  spawn(fn, world, device)   -> start `world` ranks on this host, run
                                fn(*args) on each, collect the results
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gasr_tpu_torch.config import resolve_device
from gasr_tpu_torch.parallel.mesh import mesh_sizes

DEFAULT_TIMEOUT_S = 300     # a rank's collectives, and a whole spawn


def _backend(device: str) -> str:
    resolve_device(device)              # raises for "cuda" without a card
    return "nccl" if device == "cuda" else "gloo"


def initialize(device: str = "cuda", init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group. Returns True if this is a multi-process run.

    Reads RANK, WORLD_SIZE and LOCAL_RANK (as `torchrun` sets them) and
    rendezvous at MASTER_ADDR:MASTER_PORT, or at `init_method` where one
    is given. Without RANK and WORLD_SIZE this is a single-process run and
    nothing is initialized (JAX's `initialize` likewise). The backend
    follows `device`: NCCL with this rank on card LOCAL_RANK for "cuda",
    gloo for "cpu".
    """
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    backend = _backend(device)
    rank = int(os.environ["RANK"])
    card = None
    if device == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s), device_id=card)
    return True


def global_mesh(mesh_shape: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """A DeviceMesh over every rank of the process group, rank r at the
    r-th place in row-major order. Sizing as `make_mesh`: {} puts every
    rank on 'data', -1 fills an axis, a mesh larger than the world
    raises; so does a smaller one, since every rank holds shards. Its
    device type follows the backend: cuda for NCCL, cpu for gloo."""
    world = dist.get_world_size()
    names, sizes = mesh_sizes(mesh_shape, world)
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} leaves ranks of "
                         f"the world of {world} out")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).view(sizes),
                      mesh_dim_names=names)


def rank_device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_local_batch_to_global(batch: Dict[str, Any], mesh: DeviceMesh,
                               specs: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """This rank's share of a data-parallel batch, on its device.

    Each rank passes the rows of the global batch that its coordinate on
    the specs' axes owns (ranks that differ only on another axis pass the
    same rows). JAX assembles one global array from the hosts' shares
    (`make_array_from_process_local_data`); in the port the global batch
    is never materialized, and each rank's share is what the sharded step
    takes. Every key needs a spec."""
    missing = sorted(set(batch) - set(specs))
    if missing:
        raise KeyError(f"batch keys {missing} have no spec")
    dev = rank_device()
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


# ------------------------------------------------------------------ spawn

def live_children() -> List[tuple]:
    """The processes this one started that still run (from /proc: its
    children that are not zombies), as (pid, command line). Linux only."""
    kids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(") ", 1)[1].split()[:2]
            if int(ppid) != os.getpid() or state == "Z":
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                kids.append((int(pid), f.read().replace(b"\0", b" ")
                             .decode(errors="replace").strip()))
        except (FileNotFoundError, ProcessLookupError):
            pass                                # ended while we looked
    return kids


# what a rank runs: `python -c _RANK_CODE <rank> <directory>`
_RANK_CODE = ("import sys; from gasr_tpu_torch.parallel.distributed import "
              "_rank_main; _rank_main(int(sys.argv[1]), sys.argv[2])")


def _rank_main(rank: int, tmp: str) -> None:
    """A rank's program: read the call that `spawn` wrote to `tmp`, join
    the process group through the file rendezvous there, run the call and
    write its result (or the traceback) back."""
    try:
        call = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
        torch.set_num_threads(call["threads"])
        device = call["device"]
        card = None
        if device == "cuda":
            card = torch.device("cuda", rank)
            torch.cuda.set_device(card)
        dist.init_process_group(
            _backend(device), init_method=f"file://{tmp}/rendezvous",
            rank=rank, world_size=call["world"],
            timeout=datetime.timedelta(seconds=call["timeout_s"]),
            device_id=card)
        try:
            result = call["fn"](*call["args"])
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, device: str, *args: Any,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: Optional[int] = None) -> List[Any]:
    """Run fn(*args) on `world` ranks of a new process group, one process
    each on this host, and return their results by rank.

    Each rank is a new Python process (a subprocess, not `multiprocessing`,
    whose helper process would outlive the caller) that joins through a
    file in a temporary directory (no TCP port, so concurrent spawns cannot
    clash), with `timeout_s` on its collectives; "cuda" puts rank r on card
    r over NCCL (more ranks than cards raises: NCCL refuses two ranks on
    one card), "cpu" runs gloo. `fn` must be importable by name (a
    module-level function of an importable module: the ranks are started
    afresh with the caller's import path) and may return tensors, numbers,
    strings and nested dicts and lists of them. torch's threads are
    `threads` a rank (default: the host's cores divided among the ranks).
    Every rank has ended when this returns. Raises with the failed ranks'
    tracebacks, or TimeoutError when the ranks have not all ended after
    `timeout_s` (they are then terminated)."""
    _backend(device)
    if device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} CUDA cards, torch "
                         f"finds {torch.cuda.device_count()}")
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    # the caller's import path, so that the ranks import what it imports
    path = [os.path.abspath(p or os.curdir) for p in sys.path]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    with tempfile.TemporaryDirectory(prefix="gasr_spawn_") as tmp:
        torch.save(dict(fn=fn, args=args, world=world, device=device,
                        timeout_s=timeout_s, threads=threads),
                   os.path.join(tmp, "call.pt"),
                   pickle_protocol=pickle.HIGHEST_PROTOCOL)
        sys.stdout.flush()
        sys.stderr.flush()
        procs, stopped = [], []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK_CODE, str(r), tmp],
                    env=env))
            # wait for every rank, or stop at the first that fails: its
            # peers would wait on it in a collective until their timeout
            deadline = time.monotonic() + timeout_s
            while (time.monotonic() < deadline
                   and any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)):
                time.sleep(0.05)
        finally:
            stopped = [r for r, p in enumerate(procs) if p.poll() is None]
            for r in stopped:
                procs[r].terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        failed = any(c for r, c in enumerate(codes) if r not in stopped)
        hung = [] if failed else stopped
        errors = []
        for r, c in enumerate(codes):
            path_r = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path_r):
                with open(path_r) as f:
                    errors.append(f"--- rank {r}\n{f.read()}")
            elif c and r not in stopped:
                # a rank that died without a traceback (not one of the
                # peers stopped above)
                errors.append(f"--- rank {r} exited with {c}")
        if failed and not errors:
            errors.append(f"exit codes {codes}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n"
                               + "\n".join(errors))
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still ran after "
                               f"{timeout_s} s")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=True) for r in range(world)]
