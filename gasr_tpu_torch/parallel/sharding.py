"""Sharding rules: partition specs for params and batches, and the moves
between whole trees and this rank's shards. The port of
`gasr_tpu/parallel/sharding.py`.

Tensor parallelism for the DeepSpeech family (the reference's 2048-wide
config is the motivating shape, baseline/config.json:6-7):

  - mlp1..3 weights [in, out]: `out` split on 'model' (column parallel),
    biases split on 'model';
  - rnn w_ih [in, H] and w_hh [H, H]: the OUTPUT dim H split, biases too;
    each step all-gathers h and computes this rank's columns of the
    pre-activation;
  - mlp5 weight [H, out]: `in` split (row parallel: it consumes the split
    RNN output, and its partial products are summed), mlp6 replicated;
  - batch [B, T, F]: B split on 'data'.

In JAX these are annotations and GSPMD inserts the collectives. In the
port every rank holds its shards of each leaf (`shard_tree`) and the
model's tensor-parallel forward issues the collectives itself
(`models/deepspeech.py::deepspeech_apply_tp`, `parallel/collectives.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gasr_tpu_torch.parallel.distributed import rank_device
from gasr_tpu_torch.runtime._tree import tree_map


class Spec:
    """A partition spec (JAX's `PartitionSpec`): for each leading
    dimension of a tensor, the name of the mesh axis it is split over, or
    None; dimensions past the spec's length are whole. `Spec()` is
    replicated."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.axes == other.axes

    def __repr__(self) -> str:
        return f"Spec{self.axes!r}"

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.axes)


def _cell_specs(tp: Optional[str]) -> dict:
    return {"w_ih": Spec(None, tp), "w_hh": Spec(None, tp),
            "b_ih": Spec(tp), "b_hh": Spec(tp)}


def deepspeech_param_specs(params: Dict[str, Any],
                           tp_axis: str = "model") -> Dict[str, Any]:
    """Spec tree matching a deepspeech params tree."""
    tp = tp_axis
    rnn = {"layers": [_cell_specs(tp) for _ in params["rnn"]["layers"]]}
    if "layers_rev" in params["rnn"]:
        rnn["layers_rev"] = [_cell_specs(tp)
                             for _ in params["rnn"]["layers_rev"]]
    return {
        "mlp1": {"w": Spec(None, tp), "b": Spec(tp)},
        "mlp2": {"w": Spec(None, tp), "b": Spec(tp)},
        "mlp3": {"w": Spec(None, tp), "b": Spec(tp)},
        "rnn": rnn,
        "mlp5": {"w": Spec(tp, None), "b": Spec(None)},
        "mlp6": {"w": Spec(None, None), "b": Spec(None)},
    }


def generic_param_specs(params: Any, tp_axis: str = "model",
                        min_dim: int = 256) -> Any:
    """Heuristic tensor-parallel specs for any model's params (BiLSTM,
    DS2, Conformer-L): the LAST axis of every weight of 2 or more
    dimensions whose last dim is >= min_dim split on `tp_axis`; every
    other leaf replicated."""
    def spec_for(x) -> Spec:
        if x.ndim >= 2 and x.shape[-1] >= min_dim:
            return Spec(*([None] * (x.ndim - 1) + [tp_axis]))
        return Spec()
    return tree_map(spec_for, params)


def batch_specs(dp_axis: str = "data") -> Dict[str, Spec]:
    """Specs for a training batch dict."""
    return {
        "inputs": Spec(dp_axis, None, None),        # [B, T, F]
        "labels": Spec(dp_axis, None),              # [B, S]
        "input_lengths": Spec(dp_axis),             # [B]
        "label_lengths": Spec(dp_axis),             # [B]
    }


def _axis(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    return names.index(axis)


def _shard(x: torch.Tensor, spec: Spec, mesh: DeviceMesh,
           device: torch.device) -> torch.Tensor:
    coord = mesh.get_coordinate()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        k = _axis(mesh, axis)
        n = mesh.size(k)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does "
                             f"not split evenly over {n} ranks of {axis!r}")
        size = x.shape[dim] // n
        x = x.narrow(dim, coord[k] * size, size)
    # a copy: the step updates its shards in place
    return x.to(device=device, memory_format=torch.contiguous_format,
                copy=True)


def shard_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """This rank's shard of every leaf of `tree` (which every rank holds
    whole and alike), per `specs`, as new tensors on the rank's device
    (JAX's `shard_tree` device-puts the whole tree with NamedShardings)."""
    dev = rank_device()
    return tree_map(
        lambda x, s: _shard(torch.as_tensor(x).detach(), s, mesh, dev),
        tree, specs)


def _gather(x: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        group = mesh.get_group(_axis(mesh, axis))
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim)
    return x


def gather_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """The inverse of `shard_tree`: every leaf whole, on every rank, from
    the ranks' shards (all-gathers over each split axis)."""
    return tree_map(lambda x, s: _gather(x, s, mesh), tree, specs)
