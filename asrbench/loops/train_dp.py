"""A closed loop of data-parallel training steps
(`train.make_sharded_train_step` on `global_mesh({"data": world,
"model": 1})`), one process a card, on a pool of "pool" batches of
"batch" utterances a rank ("world" ranks; the global batch is "world" x
"batch"). The utterances and labels are drawn as `loops/train.py` draws
them, each rank's shard from its own generator of the seed.

Rank 0 is the harness's own process, on card 0. Ranks 1.. are child
processes (`python -c FOLLOW`, rank r on card r) that draw the same
weights from the seed, join the group through a file rendezvous in the
run's temporary directory (NCCL between cards, gloo on the CPU), and
then follow rank 0 one step at a time: for each step rank 0 writes one
byte on each follower's standard input, the index of the step's batch in
the pool, and every rank calls the sharded step on its own shard of that
batch. Once the window has closed, rank 0 writes
the byte that ends them, and every rank leaves the group at once; each
follower then reports its card and its peak memory. A follower ends
also when its standard input closes, when rank 0's process dies, and
after its own time limit, so none outlives the run. On a card each rank
keeps to its own share of the cores.

Set-up joins the group and drives the step through its first three
steps, and the comparison reads rank 0's state as `loops/train.py`
does: the first gradient and each leaf's change against three reference
steps, and the window's last step from the state copied aside before
it. The reference steps take the whole global batch (rank 0 draws every
rank's shard again after the window), a shard's rows at a time, and its
gradient is the mean over all of them. Faults planted in the reference
in the program's place: half of each shard left out; one rank's shard
left out, the mean taken over the other ranks'; the exchange left out,
rank 0 stepping on its own shard alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from asrbench import judge
from asrbench import weights as wmod
from asrbench.common import generator, program_config
from asrbench.loops import train

# what a follower runs: `python -c FOLLOW <rank> <directory>`
FOLLOW = ("import sys; from asrbench.loops.train_dp import follow; "
          "follow(int(sys.argv[1]), sys.argv[2])")
END = 255                      # the byte that ends a follower
GROUP_TIMEOUT_S = 180          # a collective, and the rendezvous
LIMIT_S = 1200                 # a follower's life: a first run's, which builds
END_WAIT_S = 60                # the followers' end, once told


def shard_seed(rank: int) -> int:
    """The sub-seed of rank `rank`'s shard of every batch."""
    return 10 + rank


def _cores(rank: int, world: int) -> List[int]:
    """Rank `rank`'s share of the cores this process may run on."""
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // world)
    return cores[rank * per:(rank + 1) * per] or cores


def _join(rank: int, world: int, tmp: str, cuda: bool) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"file://{tmp}/rendezvous",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        device_id=torch.device("cuda", rank) if cuda else None)


def _sharded_step(cell, cfg, params):
    """The program's sharded step, this rank's leaves and their AdamW
    state, on the benchmark's whole weights `params`."""
    from gasr_tpu_torch.parallel.distributed import global_mesh
    from gasr_tpu_torch.train import make_optimizer, make_sharded_train_step
    opt = cell.config["optimizer"]
    mesh = global_mesh({"data": cell.traffic["world"], "model": 1})
    return make_sharded_train_step(
        cfg, mesh, make_optimizer(opt["learning_rate"], opt["weight_decay"]),
        params=params)


def _leave() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class Load(train.Load):
    SPANS = ("forward", "ctc", "backward", "allreduce", "optimizer")
    PHASES = ("ctc", "backward", "allreduce", "optimizer")
    MARK_SPANS = train.Load.MARK_SPANS + (
        ("allreduce_train", "backward", "allreduce"),)

    def __init__(self, cell, params, seed: int, device: str, spans):
        t = cell.traffic
        # the reference takes the global batch a shard's rows at a time
        self.cell = dataclasses.replace(cell, config=dict(
            cell.config, reference_block_rows=t["batch"]))
        self.cfg = program_config(cell, device)
        self.B, self.T, self.world = t["batch"], t["frames"], t["world"]
        if t["pool"] >= END:
            raise ValueError(f"asrbench: a pool of {t['pool']} batches; a "
                             f"byte names at most {END}")
        self.seed, self.device = seed, device
        self.pool = train.make_pool(
            cell, self.cfg, generator(seed, shard_seed(0), device), device)
        self.params, self.spans = params, spans
        self.start = [p.detach().clone() for _, p in wmod.leaves(params)]
        self.readings: Dict[str, torch.Tensor] = {}
        self.losses: List[torch.Tensor] = []
        self.snap: Optional[Dict] = None
        self.snap_i: Optional[int] = None
        self.final: Optional[Dict] = None
        self.followers: List[subprocess.Popen] = []
        self.tmp: Optional[str] = None

    # ------------------------------------------------------------- ranks

    def _start(self) -> None:
        """Start ranks 1.., join the group with them and build the
        sharded step."""
        cuda = self.device == "cuda"
        if cuda and torch.cuda.device_count() < self.world:
            raise RuntimeError(f"asrbench: {self.world} ranks need "
                               f"{self.world} cards, found "
                               f"{torch.cuda.device_count()}")
        self.tmp = tempfile.mkdtemp(prefix="asrbench_dp_")
        c = self.cell
        with open(os.path.join(self.tmp, "cell.json"), "w") as f:
            json.dump({"name": c.name, "config": c.config,
                       "traffic": c.traffic, "seed": self.seed,
                       "device": self.device}, f)
        path = [os.path.abspath(p or os.curdir) for p in sys.path]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
        sys.stdout.flush()
        sys.stderr.flush()
        for r in range(1, self.world):
            # a follower's output goes to this process's standard error:
            # the result is the last line of its standard output
            self.followers.append(subprocess.Popen(
                [sys.executable, "-c", FOLLOW, str(r), self.tmp],
                stdin=subprocess.PIPE, stdout=2, env=env))
        if cuda:
            torch.set_num_threads(len(_cores(0, self.world)))
            os.sched_setaffinity(0, _cores(0, self.world))
        _join(0, self.world, self.tmp, cuda)
        # from here on the step's own tree of this rank's leaves
        self.step, self.params, self.opt_state = _sharded_step(
            c, self.cfg, self.params)
        self.leaves = self.opt_state.param_groups[0]["params"]

    def _tell(self, byte: int) -> None:
        for p in self.followers:
            p.stdin.write(bytes((byte,)))
            p.stdin.flush()

    def warm(self) -> None:
        self._start()
        super().warm()

    def call(self, i: int):
        self._tell(i % len(self.pool))
        return super().call(i)

    def capture(self, i: int, out) -> None:
        # the step's loss is a view of its all-reduce buffer (85 MB at
        # reference_large): keep a copy, not every step's buffer
        self.losses.append(out[2]["loss"].clone())
        if i == self.snap_i:
            self.snap_out = out[2]

    def leave(self) -> List[tuple]:
        """The followers told to end; every rank leaves the group at once,
        then each follower's (card, peak) once it has ended."""
        if self.device == "cuda":
            torch.cuda.synchronize()
        self._tell(END)
        for p in self.followers:
            p.stdin.close()
        _leave()
        out = []
        for r, p in enumerate(self.followers, start=1):
            try:
                code = p.wait(timeout=END_WAIT_S)
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                raise RuntimeError(f"asrbench: rank {r} ended with {code}")
            with open(os.path.join(self.tmp, f"rank{r}.json")) as f:
                rep = json.load(f)
            out.append((rep["card"], rep["peak"]))
        self.followers = []
        return out

    def close(self) -> None:
        """Stop any follower left (a run that failed) and remove the
        rendezvous directory."""
        for p in self.followers:
            if p.poll() is None:
                p.kill()
            p.wait()
        self.followers = []
        if self.device != "cuda":
            # gloo leaves at once; NCCL with its peers gone may not, and the
            # process of a failed run on the card ends anyway
            _leave()
        if self.tmp is not None:
            for name in os.listdir(self.tmp):
                os.remove(os.path.join(self.tmp, name))
            os.rmdir(self.tmp)
            self.tmp = None

    # ------------------------------------------------------ the judgement

    def _global(self) -> List[Dict[str, torch.Tensor]]:
        """The pool's global batches: every rank's shard, in rank order,
        drawn again from the seed on this card."""
        shards = [self.pool] + [
            train.make_pool(self.cell, self.cfg,
                            generator(self.seed, shard_seed(r), self.device),
                            self.device)
            for r in range(1, self.world)]
        return [{k: torch.cat([s[i][k] for s in shards])
                 for k in self.pool[i]} for i in range(len(self.pool))]

    def _batches(self):
        g = self._global()
        return ([g[i % len(g)] for i in range(3)],
                g[self.snap_i % len(g)])

    def _in_place(self, params, precision, rows=None) -> Dict:
        """The numbers with the reference at `precision` in the program's
        place, over the global batch's rows `rows` (default: all)."""
        conf, prec = self.cell.config, self.precision()
        first, last = self._batches()

        def pick(b):
            return b if rows is None else {k: v[rows] for k, v in b.items()}
        params0 = wmod.with_leaves(params, self.start)
        got = judge.reference_steps(conf, params0, [pick(b) for b in first],
                                    precision)
        vals, _ = judge.train_numbers(conf, params0, first, got, prec)
        state = self._state()
        ref = judge.step_from(conf, params, state, last, prec)
        vals.update(judge.timed_numbers(
            judge.step_from(conf, params, state, pick(last), precision),
            ref))
        return vals

    def fault_numbers(self, params) -> Dict[str, Dict]:
        B, n = self.B, self.world
        dev = self.start[0].device
        half = torch.cat([torch.arange(r * B, r * B + B // 2)
                          for r in range(n)]).to(dev)
        return {"half_batch": self._in_place(params, self.precision(), half),
                "rank_left_out": self._in_place(
                    params, self.precision(),
                    torch.arange(B, n * B, device=dev)),
                "exchange_left_out": self._in_place(
                    params, self.precision(), torch.arange(B, device=dev))}


# ---------------------------------------------------------------- follower

def _die_with_parent() -> None:
    """Ask Linux to kill this process when its parent ends."""
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def follow(rank: int, tmp: str) -> None:
    """Rank `rank` (1..): join the group, then one sharded step on its own
    shard of the pool's batch that each byte on standard input names,
    until the end byte or the end of the input; then leave the group at
    once and report its card and peak memory in `tmp`."""
    from asrbench import harness
    from asrbench.manifest import Cell

    _die_with_parent()
    with open(os.path.join(tmp, "cell.json")) as f:
        spec = json.load(f)
    signal.alarm(LIMIT_S)
    world, device = spec["traffic"]["world"], spec["device"]
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.set_num_threads(len(_cores(rank, world)))
        os.sched_setaffinity(0, _cores(rank, world))
    else:
        torch.set_num_threads(1)
    cell = Cell(name=spec["name"], config_name="", config=spec["config"],
                traffic_name="", traffic=spec["traffic"], limits=None,
                end_to_end=[], per_layer=[], readers={}, chips=world)
    harness._set_tf32(cell.config)
    seed = spec["seed"]
    params = wmod.make(cell.config["family"], cell.config["model"],
                       generator(seed, 1, device), device)
    cfg = program_config(cell, device)
    pool = train.make_pool(cell, cfg, generator(seed, shard_seed(rank),
                                                device), device)
    _join(rank, world, tmp, cuda)
    try:
        step, local, opt_state = _sharded_step(cell, cfg, params)
        del params
        while True:
            b = sys.stdin.buffer.read(1)
            if not b or b[0] == END:
                break
            local, opt_state, _ = step(local, opt_state, pool[b[0]])
        if cuda:
            torch.cuda.synchronize()
    finally:
        _leave()
    rep = {"card": harness.card(cuda),
           "peak": torch.cuda.max_memory_allocated() if cuda else 0}
    tmp_rep = Path(tmp) / f"rank{rank}.json.part"
    tmp_rep.write_text(json.dumps(rep))
    os.replace(tmp_rep, Path(tmp) / f"rank{rank}.json")
