"""SpecAugment (Park et al. 2019) time and frequency masking, the port of
`gasr_tpu/data/augment.py`.

The masks' widths and starts are drawn per utterance from a
`torch.Generator` on the features' device, so the draws cannot equal
the JAX package's (its key splits); the masks follow the same rules.
"""

from __future__ import annotations

import torch


def _draw(generator: torch.Generator, B: int, n: int,
          max_width: int, device) -> tuple:
    """Per utterance: a width uniform in [0, max_width] and a start
    uniform in [0, max(n - width + 1, 1)), each [B, 1, 1]."""
    width = torch.randint(0, max_width + 1, (B, 1, 1), generator=generator,
                          device=device)
    high = (n - width + 1).clamp(min=1)
    u = torch.rand((B, 1, 1), generator=generator, device=device)
    start = torch.minimum((u * high).long(), high - 1)
    return width, start


def spec_augment(feats: torch.Tensor, generator: torch.Generator,
                 num_time_masks: int = 2, max_time_frac: float = 0.05,
                 num_freq_masks: int = 2, max_freq: int = 10,
                 mask_value: float = 0.0) -> torch.Tensor:
    """feats [B, T, F] -> a masked copy: `num_time_masks` runs of at most
    max(int(T * max_time_frac), 1) frames and `num_freq_masks` runs of at
    most min(max_freq, F) bins, each set to mask_value, drawn per
    utterance from `generator` (a generator of feats' device)."""
    B, T, F = feats.shape
    dev = feats.device
    max_t = max(int(T * max_time_frac), 1)
    out = feats
    t_idx = torch.arange(T, device=dev)[None, :, None]       # [1, T, 1]
    f_idx = torch.arange(F, device=dev)[None, None, :]       # [1, 1, F]
    for _ in range(num_time_masks):
        width, start = _draw(generator, B, T, max_t, dev)
        mask = (t_idx >= start) & (t_idx < start + width)
        out = torch.where(mask, mask_value, out)
    for _ in range(num_freq_masks):
        width, start = _draw(generator, B, F, min(max_freq, F), dev)
        mask = (f_idx >= start) & (f_idx < start + width)
        out = torch.where(mask, mask_value, out)
    return out
