"""What every loop shares: seeds derived from `--seed`, the program's
configuration of a cell, inputs drawn on the device, and utterance
lengths drawn from a set that every seed shares."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from asrbench.manifest import Cell

FRAME_S = 0.010              # seconds of audio a feature frame


def sub_seed(seed: int, k: int) -> int:
    """A derived seed: weights, inputs and sampling draw apart."""
    return (int(seed) * 1_000_003 + 7_919 * k) % (2 ** 62)


def generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, k))


def program_config(cell: Cell, device: str):
    from gasr_tpu_torch.config import Config
    t = cell.traffic
    d = dict(cell.config["program"], device=device,
             batch_size=t.get("batch", t.get("streams")),
             seg_len=t["frames"])
    return Config.from_dict(d)


def compute_dtype(cfg):
    return None if cfg.compute_dtype == "float32" else getattr(
        torch, cfg.compute_dtype)


def features(gen, n: int, B: int, T: int, F: int, device
             ) -> List[torch.Tensor]:
    """n batches [B, T, F] uniform in [0, 1)."""
    return [torch.rand((B, T, F), generator=gen, device=device)
            for _ in range(n)]


def spread_set(gen, n: int, lo: float, hi: float, device) -> torch.Tensor:
    """n values evenly spread over [lo, hi] (the midpoints of n equal
    steps), in an order drawn from `gen`: every seed gets the same set,
    so the same work, in another order."""
    k = torch.arange(n, dtype=torch.float64)
    vals = lo + (hi - lo) * (k + 0.5) / n
    return vals[torch.randperm(n, generator=gen, device=device).cpu()]


def lengths(traffic: Dict, gen, n_batches: int, B: int, device
            ) -> Optional[List[torch.Tensor]]:
    """Per-utterance frame counts [B] int32 of each batch, from the mix's
    "min_frames" up to its "frames" (a length bucket padded to its
    longest); None where the mix has no "min_frames" (every utterance
    "frames" long)."""
    if "min_frames" not in traffic:
        return None
    vals = spread_set(gen, n_batches * B, traffic["min_frames"],
                      traffic["frames"], device).round().to(torch.int32)
    return [vals[i * B:(i + 1) * B].to(device) for i in range(n_batches)]


def pad_past(x: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, T, F] with every frame at t >= lens[b] zero (the padding of
    a batch of utterances of lengths `lens`), in place."""
    if lens is not None:
        t = torch.arange(x.shape[1], device=x.device)
        x.masked_fill_((t[None, :] >= lens[:, None])[:, :, None], 0.0)
    return x


def untracked(lists) -> tuple:
    """Transcripts [(tokens, score)] as tuples of ints and floats, which
    Python's collector stops scanning at its first pass over them."""
    return tuple((tuple(tok), float(score)) for tok, score in lists)


def percentile_ms(values: List[float], pct: int) -> float:
    """The pct-th percentile of `values` (seconds), in ms."""
    if len(values) == 1:
        return values[0] * 1e3
    return statistics.quantiles(values, n=100,
                                method="inclusive")[pct - 1] * 1e3
