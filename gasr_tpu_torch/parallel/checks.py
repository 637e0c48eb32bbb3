"""Rank programs that hold the parallel modules to their single-process
twins. Each runs on every rank of a `distributed.spawn` world and returns
plain data (tensors on the CPU, numbers, flags) for the caller to
compare; `run_each` runs several in one world, so that one spawn serves
many checks. The tests, `graft_entry.dryrun_multichip` and
`chip_smoke.py` drive them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from gasr_tpu_torch.models.deepspeech import deepspeech_apply_tp
from gasr_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                 copy_to_group)
from gasr_tpu_torch.parallel.distributed import global_mesh
from gasr_tpu_torch.parallel.sharding import (
    Spec, deepspeech_param_specs, gather_tree, shard_tree)
from gasr_tpu_torch.runtime._tree import leaves, tree_map
from gasr_tpu_torch.runtime.checkpoint import (load_params_dcp,
                                               save_params_dcp)


def run_each(calls: Sequence[Tuple[Callable, tuple]]) -> List[Any]:
    """fn(*args) for each (fn, args) of `calls`, in order, in this rank's
    process group; their results in a list."""
    return [fn(*args) for fn, args in calls]


def collectives_run(xs: List[torch.Tensor],
                    gs: Dict[str, List[torch.Tensor]], dim: int
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each collective Function of `parallel/collectives.py` over the whole
    world on this rank's input xs[rank] (alike on every rank for
    copy_to_group), and its grad for this rank's cotangent gs[op][rank]:
    {op: (output, grad of the input)}."""
    r, group = dist.get_rank(), dist.group.WORLD
    ops = {"all_gather": lambda x: all_gather(x, group, dim),
           "all_reduce": lambda x: all_reduce(x, group),
           "copy_to_group": lambda x: copy_to_group(x, group)}
    out = {}
    for name, op in ops.items():
        x = (xs[0] if name == "copy_to_group" else xs[r]).clone()
        x.requires_grad_(True)
        y = op(x)
        (gx,) = torch.autograd.grad(y, x, gs[name][r])
        out[name] = (y.detach(), gx)
    return out


def tp_forward_run(params: Any, x: torch.Tensor,
                   mesh_shape: Dict[str, int]) -> torch.Tensor:
    """`deepspeech_apply_tp` on this rank's shards over "model" and its
    rows of x over "data": this rank's log-probs [T, B / data, V+1]."""
    mesh = global_mesh(mesh_shape)
    local = shard_tree(params, deepspeech_param_specs(params), mesh)
    x_local = shard_tree(x, Spec("data"), mesh)
    with torch.no_grad():
        return deepspeech_apply_tp(local, x_local,
                                   mesh.get_group("model")).cpu()


def roundtrip_run(tree: Any, specs: Any,
                  mesh_shape: Dict[str, int]) -> Dict[str, Any]:
    """`shard_tree` then `gather_tree`: whether every leaf came back bit
    for bit, and this rank's shard shapes."""
    mesh = global_mesh(mesh_shape)
    local = shard_tree(tree, specs, mesh)
    back = gather_tree(local, specs, mesh)
    same = all(torch.equal(a.cpu(), torch.as_tensor(b))
               for a, b in zip(leaves(back), leaves(tree)))
    return {"equal": same,
            "shapes": [tuple(t.shape) for t in leaves(local)]}


def checkpoint_run(path: str, params: Any, save_shape: Dict[str, int],
                   load_shape: Dict[str, int]) -> Dict[str, Any]:
    """`save_params_dcp` of this rank's deepspeech shards on a mesh of
    `save_shape`, then `load_params_dcp` into a mesh of `load_shape` over
    the same ranks: whether the loaded shards are `shard_tree`'s of the
    whole params bit for bit, and (rank 0) the loaded params gathered
    whole on the CPU."""
    specs = deepspeech_param_specs(params)
    mesh = global_mesh(save_shape)
    save_params_dcp(path, shard_tree(params, specs, mesh), specs, mesh)
    mesh2 = global_mesh(load_shape)
    want = shard_tree(params, specs, mesh2)
    got = load_params_dcp(path, tree_map(torch.zeros_like, want), specs,
                          mesh2)
    same = all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    whole = gather_tree(got, specs, mesh2)
    return {"equal": same,
            "params": (tree_map(lambda t: t.to("cpu", copy=True), whole)
                       if dist.get_rank() == 0 else None)}
