"""Greedy (best-path) CTC decode: argmax per frame -> collapse repeats ->
drop blanks, compacted with one scatter."""

from __future__ import annotations

from typing import Tuple

import torch


def greedy_decode(log_probs: torch.Tensor, blank_id: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_probs: [T, B, V] -> (tokens [B, T] int32 -1-padded, lengths [B])."""
    T, B, V = log_probs.shape
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32).T       # [B, T]
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = (ids != prev) & (ids != blank_id)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1           # write index
    lengths = keep.sum(dim=1).to(torch.int32)
    pos = torch.where(keep, pos, T)                               # T = discard
    out = torch.full((B, T + 1), -1, dtype=torch.int32, device=ids.device)
    out.scatter_(1, pos, torch.where(keep, ids, -1))
    return out[:, :T], lengths
