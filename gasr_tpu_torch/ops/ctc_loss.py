"""CTC loss: the Graves forward recursion in the log domain over the
blank-interleaved labels, the port of `gasr_tpu/ops/ctc_loss.py`.

The recursion is a T-step loop over [B, 2S+1] states with the JAX
package's expressions (`_logsumexp3` with its -80 clamp and 1e-37,
NEG_INF = -1e30), and its gradient is autograd's, as JAX's is jax.grad's
through its `lax.scan`. `torch.maximum` splits the gradient in half at
ties, as `jnp.maximum` does; ties occur where every operand is NEG_INF
(unreachable states), so `torch.clamp`, which gives the whole gradient
to one side, is not used.

Variable input lengths use the JAX package's padding trick: frames at or
past `input_lengths` become a deterministic blank (log-prob 0 for blank,
NEG_INF otherwise), which leaves the total probability unchanged, so the
loop always runs T steps. The emissions along the extended labels are
one gather, [T, B, V] -> [T, B, 2S+1] (the JAX package's one-hot einsum
is a way onto the TPU's matrix unit, not a different function).

`ctc_loss` dispatches on its input: CUDA tensors go to the kernel pair of
`csrc/ctc_loss.cu` (`ops/cuda/ctc_loss.py`: the recursion and its adjoint,
one launch each, the same expressions and the same gradient); every other
tensor goes to `ctc_loss_plain`, the eager loop above under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.cuda import ctc_loss as ctc_kernels
from gasr_tpu_torch.runtime.profiler import span

NEG_INF = -1.0e30


def _logsumexp3(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b + e^c), each term dropped below e^-80 of the largest,
    never below NEG_INF (`ctc_loss.py::_logsumexp3`)."""
    neg = torch.tensor(NEG_INF, dtype=a.dtype, device=a.device)
    floor = torch.tensor(-80.0, dtype=a.dtype, device=a.device)
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.maximum(m, neg)
    da, db, dc = a - m_safe, b - m_safe, c - m_safe
    out = m + torch.log(
        torch.exp(torch.maximum(da, floor)) * (da > -80.0)
        + torch.exp(torch.maximum(db, floor)) * (db > -80.0)
        + torch.exp(torch.maximum(dc, floor)) * (dc > -80.0)
        + 1e-37)
    return torch.maximum(out, neg)


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-example negative log-likelihood [B] (not length-normalised, as
    torch's reduction='none').

    log_probs [T, B, V] time-major float32 log-probabilities; labels
    [B, S] target ids (no blanks), padded arbitrarily; input_lengths and
    label_lengths [B] (label_lengths <= S). An example no alignment can
    produce (labels longer than its frames allow) gets a loss near 1e30,
    as in the JAX package. On CUDA tensors the kernel pair, under the span
    "ctc.loss" (the forward's launch; the backward's runs in autograd's
    backward); on other tensors `ctc_loss_plain`."""
    if log_probs.device.type == "cuda":
        with span("ctc.loss"):
            return ctc_kernels.ctc_loss(log_probs, labels, input_lengths,
                                        label_lengths, blank_id)
    return ctc_loss_plain(log_probs, labels, input_lengths, label_lengths,
                          blank_id)


def ctc_loss_plain(log_probs: torch.Tensor, labels: torch.Tensor,
                   input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                   blank_id: int = 0) -> torch.Tensor:
    """`ctc_loss` as a T-step eager loop on any device, differentiable by
    autograd: the plain version the kernel pair is held to. The span
    "ctc.loss" covers the recursion's T - 1 steps, issued one by one from
    the host."""
    T, B, V = log_probs.shape
    S = labels.shape[1]
    L = 2 * S + 1
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.long)
    input_lengths = input_lengths.to(dev)
    label_lengths = label_lengths.to(dev)

    # extended sequence z: blank, l1, blank, l2, ..., blank
    k = torch.arange(L, device=dev)
    is_lab = k % 2 == 1
    lab_idx = (k // 2).clamp(0, max(S - 1, 0))
    z = torch.where(is_lab[None, :], labels[:, lab_idx],
                    torch.full((), blank_id, device=dev))        # [B, L]
    ext_len = 2 * label_lengths + 1

    # skip transition into k iff z[k] is a label and z[k] != z[k-2]
    z_m2 = F.pad(z, (2, 0), value=-1)[:, :L]
    can_skip = is_lab[None, :] & (z != z_m2)                      # [B, L]

    # frames at or past input_length -> a deterministic blank
    pad = (torch.arange(T, device=dev)[:, None]
           >= input_lengths[None, :])                             # [T, B]
    blank_row = torch.where(torch.arange(V, device=dev) == blank_id, 0.0,
                            NEG_INF).to(log_probs.dtype)
    lp = torch.where(pad[:, :, None], blank_row, log_probs)      # [T, B, V]
    e_all = lp.gather(2, z[None].expand(T, B, L))                 # [T, B, L]

    valid_k = k[None, :] < ext_len[:, None]                       # [B, L]
    alpha0 = torch.full((B, L), NEG_INF, dtype=lp.dtype, device=dev)
    alpha0[:, 0] = 0.0
    alpha0[:, 1] = torch.where(label_lengths > 0, 0.0, NEG_INF)
    alpha = torch.where(valid_k, alpha0 + e_all[0], NEG_INF)

    with span("ctc.loss"):
        for t in range(1, T):
            a1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :L]
            a2 = torch.where(can_skip,
                             F.pad(alpha, (2, 0), value=NEG_INF)[:, :L],
                             NEG_INF)
            alpha = torch.where(valid_k,
                                _logsumexp3(alpha, a1, a2) + e_all[t],
                                NEG_INF)

    # the answer: logsumexp of the last two valid positions
    last = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    last2 = alpha.gather(1, (ext_len - 2).clamp(0, L - 1)[:, None])[:, 0]
    last2 = torch.where(ext_len >= 2, last2, NEG_INF)
    total = _logsumexp3(last, last2, torch.full_like(last, NEG_INF))
    return -total
