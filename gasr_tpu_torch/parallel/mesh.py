"""Device meshes: the counterpart of `gasr_tpu/parallel/mesh.py`.

A `Mesh` is an ndarray of `torch.device`s with one named axis per
dimension: 'data' for utterance-batch parallelism, 'model' for tensor
parallelism (the vocab-sharded decode of `parallel/decode_tp.py`).

A caller may list the same device more than once, for example
`[torch.device("cuda:0")] * 4` or `[torch.device("cpu")] * 8`. That is the
counterpart of JAX's virtual host devices
(`--xla_force_host_platform_device_count`): every shard of such a mesh
runs on the one device, through the same code and the same exchange
protocol as shards on separate cards. The tests and `chip_smoke.py`
build their n-shard meshes on one card this way.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """`devices`: an ndarray of `torch.device`, one dimension per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dimensions given "
                             f"{len(axis_names)} axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def _all_cards():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: torch finds no CUDA device; pass devices= (e.g. "
            "[torch.device('cpu')] * n) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_sizes(mesh_shape: Optional[Dict[str, int]],
               n_devices: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """`make_mesh`'s sizing rule: (axis names, sizes) of `mesh_shape` over
    `n_devices`. Empty/None -> all devices on 'data'; -1 for one axis
    fills it with the remaining devices; more devices than there are
    raises."""
    if not mesh_shape:
        mesh_shape = {"data": n_devices}
    names = list(mesh_shape.keys())
    sizes = list(mesh_shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n_devices // known
    total = int(np.prod(sizes))
    if total > n_devices:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, "
            f"have {n_devices}")
    return tuple(names), tuple(sizes)


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from {axis: size}. Empty/None -> all devices on 'data'.

    Sizes must multiply to <= len(devices); -1 for one axis means
    "fill with remaining devices". `devices` defaults to every CUDA card
    and raises without one; it may repeat a device (module docstring).
    """
    devices = [torch.device(d) for d in
               (devices if devices is not None else _all_cards())]
    names, sizes = mesh_sizes(mesh_shape, len(devices))
    total = int(np.prod(sizes))
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), axis_names=tuple(names))


def default_mesh_shape(n_devices: int) -> Dict[str, int]:
    """Reasonable (data, model) factorization for n devices."""
    if n_devices == 1:
        return {"data": 1, "model": 1}
    model = 1
    n = n_devices
    # give model parallelism up to 4-way when divisible, rest to data
    for m in (4, 2):
        if n % m == 0:
            model = m
            break
    return {"data": n_devices // model, "model": model}


def model_row(mesh: Mesh, axis: str = "model") -> list:
    """The devices of the mesh's first row along `axis` (every other axis
    at index 0), in axis order: the shards of one tensor-parallel group."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    k = mesh.axis_names.index(axis)
    index = tuple(slice(None) if i == k else 0
                  for i in range(len(mesh.axis_names)))
    return list(mesh.devices[index])
