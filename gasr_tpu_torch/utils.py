"""Small debug utilities (the port's copy of `gasr_tpu/utils.py`).

print_array_info mirrors the reference's printMatrixInfo debug printer
(cuMatrix.cpp:8-16: dims and contents) with the tensor's dtype, device
and a truncated value preview.
"""

from __future__ import annotations

import numpy as np
import torch

from gasr_tpu_torch.runtime._tree import tensors


def print_array_info(x: torch.Tensor, name: str = "array",
                     max_values: int = 8) -> None:
    """Shape, dtype, device and a summary of a tensor (copies it to the
    host)."""
    host = x.detach().float().cpu().numpy() if x.is_floating_point() \
        else x.detach().cpu().numpy()
    flat = host.ravel()
    head = np.array2string(flat[:max_values], precision=4, separator=", ")
    stats = ""
    if x.is_floating_point() and flat.size:
        stats = (f" min={flat.min():.4g} max={flat.max():.4g}"
                 f" mean={flat.mean():.4g}"
                 f" finite={np.isfinite(flat).all()}")
    print(f"[{name}] shape={tuple(x.shape)} dtype={x.dtype}"
          f" device={x.device}{stats} head={head}")


def tree_size_bytes(tree) -> int:
    """Total bytes of the tensors of a params tree."""
    return sum(t.nelement() * t.element_size() for t in tensors(tree))
