"""Input validation with typed, actionable errors, non-finite detection
at pipeline boundaries and the fault injector of the bench's
`--fault-inject` drill (the port's copy of
`gasr_tpu/runtime/validation.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from gasr_tpu_torch.runtime._tree import tensors


class ShapeError(ValueError):
    """Input does not match the model/decoder contract."""


class NumericsError(FloatingPointError):
    """Non-finite values detected in a pipeline tensor."""


def check_features(x, feat_size: int) -> None:
    if x.ndim != 3:
        raise ShapeError(
            f"features must be [batch, frames, feat]; got shape "
            f"{tuple(x.shape)}")
    if x.shape[-1] != feat_size:
        raise ShapeError(
            f"feature width {x.shape[-1]} != configured feat_size "
            f"{feat_size} (input_size*(1+2*n_context))")


def check_log_probs(lp, vocab_plus_blank: Optional[int] = None) -> None:
    if lp.ndim != 3:
        raise ShapeError(
            f"log_probs must be [T, B, V]; got shape {tuple(lp.shape)}")
    if vocab_plus_blank is not None and lp.shape[-1] != vocab_plus_blank:
        raise ShapeError(
            f"vocab dim {lp.shape[-1]} != vocab_size+1 ={vocab_plus_blank} "
            "(inconsistent vocabulary size in CTC decoder)")


def assert_finite(x, name: str = "tensor") -> None:
    """Host-synced non-finite check of every floating tensor in `x`
    (nested dicts, lists, tuples, dataclasses): use it at pipeline
    boundaries, not in hot loops."""
    for t in tensors(x):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise NumericsError(f"non-finite values detected in {name}")


def inject_fault(x: torch.Tensor, kind: str = "nan",
                 position: int = 0) -> torch.Tensor:
    """A copy of `x` with element `position` (flat index) corrupted, for
    failure-detection drills; `x` is left as it was."""
    val = {"nan": float("nan"), "inf": float("inf"), "neg": -1e30}[kind]
    flat = x.reshape(-1).clone()
    flat[position] = val
    return flat.reshape(x.shape)
