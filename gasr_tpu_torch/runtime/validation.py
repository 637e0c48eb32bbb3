"""Input validation with typed, actionable errors."""

from __future__ import annotations

from typing import Optional


class ShapeError(ValueError):
    """Input does not match the model/decoder contract."""


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
