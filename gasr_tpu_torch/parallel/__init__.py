"""Device meshes and the model-axis (vocab-sharded) beam-search decode."""
from gasr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, default_mesh_shape, make_mesh,
)
