"""The epilogue of a block linear: `csrc/bias_act.cu`, one launch a
linear, on the bf16 inference path.

    t   = bf16(y + float(bf16(b)))      (y the float32 product, b [n])
    out = t | t * s(t) (swish) | t[..., :n/2] * s(t[..., n/2:]) (GLU)
          | F.gelu(t) (GELU, the exact erf form, wav2vec 2.0's)

with s the JAX package's sigmoid, 1 / (1 + exp(-u)), each step rounded to
bf16 (`sigmoid_plain`). Replaces no Pallas kernel: the JAX package's
linears and activations are plain jnp (`gasr_tpu/models/conformer.py`).
`bias_act_plain` is the port's eager version, the model's float32,
autograd and CPU path (`models/conformer.py::_lin`,
`models/wav2vec2.py::_lin`, the biased qkv products of
`ops/attention.py`).

`bias_act` launches the kernel for CUDA tensors: y float32 [..., n],
contiguous and 16-byte aligned, n a multiple of 8 (16 for "glu"); b
float32 [n], contiguous; it returns bf16 [..., n] ([..., n/2] for "glu"),
contiguous, bit-equal to `bias_act_plain`'s (for "gelu": to `F.gelu` of
the bf16 t as PyTorch's CUDA kernel computes it). It raises on what the kernel
does not take, and for inputs that require grad while autograd records
(the kernel has no backward). `bias_act_eligible` is the model's rule for
taking it, `epilogue` the sites' choice between the two. `launches` counts
launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by bias_act (one a call)
launches = 0

# the forms after the bias add and the rounding: csrc/bias_act.cu's `Act`
ACTS = {"none": 0, "swish": 1, "glu": 2, "gelu": 3}

_entry = None


def sigmoid_plain(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid's expression, 1 / (1 + exp(-x)), each step rounded
    to x's dtype (torch.sigmoid rounds once from float32, which differs
    in about a third of bf16 outputs)."""
    return 1.0 / (1.0 + torch.exp(-x))


def bias_act_plain(y: torch.Tensor, b: torch.Tensor, act: str = "none",
                   cd: Optional[torch.dtype] = None) -> torch.Tensor:
    """y + b (b first rounded to cd), rounded to cd, then `act`: the
    linear's float32 bias add and the model's eager swish, GLU or GELU
    after it. Without cd everything stays float32."""
    if cd is not None:
        b = b.to(cd)
    y = y + b.float()
    if cd is not None:
        y = y.to(cd)
    if act == "swish":
        return y * sigmoid_plain(y)
    if act == "glu":
        a, g = y.chunk(2, dim=-1)
        return a * sigmoid_plain(g)
    if act == "gelu":
        return F.gelu(y)
    if act != "none":
        raise ValueError(f"unknown act {act!r}")
    return y


def _takes(y: torch.Tensor, b: torch.Tensor, act: str) -> Optional[str]:
    """Why the kernel does not take these inputs, or None."""
    if act not in ACTS:
        return f"act must be one of {sorted(ACTS)}, got {act!r}"
    if y.dtype != torch.float32 or y.ndim == 0:
        return f"y must be float32 [..., n], got {y.dtype} {tuple(y.shape)}"
    n, m = y.shape[-1], 16 if act == "glu" else 8
    if n == 0 or n % m:
        return f"y's width n must be a multiple of {m}, got {n}"
    if not y.is_contiguous() or y.data_ptr() % 16:
        return (f"y must be contiguous and 16-byte aligned, strides "
                f"{y.stride()}")
    if b.dtype != torch.float32 or b.shape != (n,) or \
            b.device != y.device or not b.is_contiguous():
        return (f"b must be float32 [{n}] contiguous on {y.device}, got "
                f"{b.dtype} {tuple(b.shape)} on {b.device}")
    return None


def _records(y: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (y.requires_grad or b.requires_grad)


def bias_act_eligible(y: torch.Tensor, b: torch.Tensor, act: str,
                      cd: Optional[torch.dtype]) -> bool:
    """The model's rule: bf16 compute, a CUDA float32 product the kernel
    takes (contiguous, 16-byte aligned, n a multiple of 8, 16 for "glu"),
    and autograd not recording."""
    return (cd == torch.bfloat16 and y.is_cuda and not _records(y, b)
            and _takes(y, b, act) is None)


def _launch(y: torch.Tensor, b: torch.Tensor, act: str) -> torch.Tensor:
    global _entry, launches
    if _entry is None:
        _entry = _lib.load("bias_act").bias_act_launch
    n = y.shape[-1]
    n_out = n // 2 if act == "glu" else n
    out = torch.empty((*y.shape[:-1], n_out), dtype=torch.bfloat16,
                      device=y.device)
    if out.numel() == 0:
        return out
    dev = y.device.index
    _lib.check(_entry(y.data_ptr(), b.data_ptr(), out.data_ptr(),
                      y.numel() // n, n, ACTS[act], dev,
                      torch.cuda.current_stream(dev).cuda_stream),
               "bias_act (bias_act_kernel)")
    launches += 1
    return out


def bias_act(y: torch.Tensor, b: torch.Tensor, act: str = "none"
             ) -> torch.Tensor:
    """`bias_act_plain(y, b, act, torch.bfloat16)` on the card, in one
    launch (none for an empty y; see the module docstring)."""
    if not y.is_cuda:
        raise ValueError(f"bias_act: y must be a CUDA tensor, got one on "
                         f"{y.device}")
    why = _takes(y, b, act)
    if why is not None:
        raise ValueError(f"bias_act: {why}")
    if _records(y, b):
        raise NotImplementedError(
            "bias_act is forward only: under autograd the model takes "
            "bias_act_plain")
    return _launch(y, b, act)


def epilogue(y: torch.Tensor, b: torch.Tensor, act: str,
             cd: Optional[torch.dtype]) -> torch.Tensor:
    """A linear's epilogue after its float32 product y: the kernel where
    `bias_act_eligible` holds, `bias_act_plain` elsewhere."""
    if bias_act_eligible(y, b, act, cd):
        return _launch(y, b, act)
    return bias_act_plain(y, b, act, cd)
