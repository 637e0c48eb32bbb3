"""Meshes, the vocab-sharded decode, and multi-card training and scaling.

Two kinds of mesh serve two kinds of path:
  - `mesh.Mesh` (`make_mesh`) is a device grid in one process, which may
    repeat a card: the vocab-sharded (tensor-parallel) beam search of
    `decode_tp.py` runs every shard from the calling process;
  - a `torch.distributed.device_mesh.DeviceMesh` with axes ("data",
    "model") over one process a card (`distributed.global_mesh`, ranks
    started by `distributed.spawn` or `torchrun`) serves the sharded train
    step (`train.make_sharded_train_step`), the sharded checkpoints, the
    data-parallel scaling harness (`scaling.py`) and `graft_entry`'s
    `dryrun_multichip`; `sharding.py` places params and batches on it and
    `collectives.py` holds the tensor-parallel forward's collectives.
"""
from gasr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, default_mesh_shape, make_mesh,
)
