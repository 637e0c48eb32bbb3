"""Plain training steps: the CTC loss (`torch.nn.functional.ctc_loss`),
autograd's gradients, clipping by the global norm and AdamW, written
out.

The step's loss is the mean over the batch of each utterance's negative
log-likelihood divided by max(label length, 1). The gradients of all
leaves are clipped together: divided by their global 2-norm where it is
1 or more. AdamW then, per leaf: p *= 1 - lr * wd; m = b1 m + (1 - b1) g;
v = b2 v + (1 - b2) g^2; p -= lr * (m / (1 - b1^t)) /
(sqrt(v / (1 - b2^t)) + eps).

The gradient is summed over blocks of rows, so that a batch whose
activations do not fit at once still gives the whole batch's gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


def batch_grads(forward: Callable, leaves: List[torch.Tensor],
                batch: Dict[str, torch.Tensor], block_rows: int,
                rows: Optional[int] = None):
    """(loss, grads) of the batch's mean loss. `rows` (default: all)
    counts only the first rows and takes the mean over them."""
    B = batch["inputs"].shape[0] if rows is None else rows
    grads = [torch.zeros_like(p) for p in leaves]
    total = torch.zeros((), device=leaves[0].device)
    for s in range(0, B, block_rows):
        e = min(B, s + block_rows)
        with torch.enable_grad():
            lp = forward(batch["inputs"][s:e])              # [T', b, V]
            lens = batch["input_lengths"][s:e].clamp(max=lp.shape[0])
            nll = F.ctc_loss(lp, batch["labels"][s:e].long(), lens.long(),
                             batch["label_lengths"][s:e].long(), blank=0,
                             reduction="none")
            part = (nll / batch["label_lengths"][s:e].float().clamp(
                min=1.0)).sum() / B
            gs = torch.autograd.grad(part, leaves, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc += g
        total += part.detach()
        del lp, nll, part, gs
    return total, grads


class AdamW:
    """Clip by the global norm, then AdamW, on `leaves` in place."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, wd: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 m: Optional[List[torch.Tensor]] = None,
                 v: Optional[List[torch.Tensor]] = None, t: int = 0):
        """From zero moments, or from moments `m`, `v` after `t` steps."""
        self.leaves, self.lr, self.wd = leaves, lr, wd
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = m if m is not None else [torch.zeros_like(p) for p in leaves]
        self.v = v if v is not None else [torch.zeros_like(p) for p in leaves]
        self.t = t

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One step; returns the clipped gradients it applied."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = 1.0 / torch.clamp(norm, min=1.0)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        clipped = []
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            g = (g.double() * scale).float()
            clipped.append(g)
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
        return clipped
