"""CTC loss on the card: the kernel pair of `csrc/ctc_loss.cu`, the Graves
forward recursion and its adjoint, as one autograd Function.

Replaces no Pallas kernel: the JAX package's loss is a `lax.scan`
(`gasr_tpu/ops/ctc_loss.py`) differentiated by jax.grad, and the port's
plain version, `ops/ctc_loss.py::ctc_loss_plain`, is that scan as a T-step
eager loop under autograd. `ctc_loss` here computes the same loss [B] and
the same d loss / d log_probs (ties of the clamped logsumexp split in
half, padded frames and invalid states zero) in float32, with one launch
of `ctc_forward_kernel` a call and one of `ctc_backward_kernel` a
backward, on the current stream. log_probs is read through its strides;
the gradient takes its layout (`torch.empty_like`). The forward saves
alpha [B, T, 2S+1] float32 for the backward, which also takes a scratch of
that size. An example with a label the loss reads outside [0, V) or a
label length outside [0, S] gets a NaN loss and gradient.

`ops/ctc_loss.py::ctc_loss` takes this path for CUDA tensors and the plain
version for CPU tensors. `launches` counts kernel launches: two for a loss
and its backward.
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches (ctc_forward_kernel and ctc_backward_kernel, one each a
# call)
launches = 0

# csrc/ctc_loss.cu: threads of a block at most (states past it are a
# strided loop), and a block's shared memory at most on the card
MAX_THREADS = 512
SMEM_MAX = 232448


def _ints(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


class _CTCLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths,
                blank_id):
        T, B, V = log_probs.shape
        S = labels.shape[1]
        dev = log_probs.device
        lib = _lib.load("ctc_loss")
        loss = torch.empty(B, device=dev, dtype=torch.float32)
        alpha = torch.empty((B, T, 2 * S + 1), device=dev,
                            dtype=torch.float32)
        with torch.cuda.device(dev):
            _lib.check(lib.ctc_forward_launch(
                _lib.ptr(log_probs), *log_probs.stride(), _lib.ptr(labels),
                _lib.ptr(input_lengths), _lib.ptr(label_lengths), T, B, V, S,
                blank_id, _lib.ptr(alpha), _lib.ptr(loss), _lib.stream(dev)),
                "ctc_loss (ctc_forward_kernel)")
        global launches
        launches += 1
        ctx.save_for_backward(log_probs, labels, input_lengths, label_lengths,
                              alpha)
        ctx.blank_id = blank_id
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        log_probs, labels, input_lengths, label_lengths, alpha = \
            ctx.saved_tensors
        T, B, V = log_probs.shape
        S = labels.shape[1]
        dev = log_probs.device
        lib = _lib.load("ctc_loss")
        g = g.float()
        grad = torch.empty_like(log_probs)
        ge = torch.empty_like(alpha)
        with torch.cuda.device(dev):
            _lib.check(lib.ctc_backward_launch(
                _lib.ptr(alpha), _lib.ptr(labels), _lib.ptr(input_lengths),
                _lib.ptr(label_lengths), _lib.ptr(g), g.stride(0), T, B, V,
                S, ctx.blank_id, _lib.ptr(ge), _lib.ptr(grad), *grad.stride(),
                _lib.stream(dev)), "ctc_loss (ctc_backward_kernel)")
        global launches
        launches += 1
        return grad, None, None, None, None


def smem_bytes(S: int, backward: bool) -> int:
    """A block's shared memory in csrc/ctc_loss.cu for S labels
    (`forward_smem`, `backward_smem`; the launch refuses more than the
    card allows): the forward's (2 + 8) L floats and 2 L ints, the
    backward's (6 + 8) L floats and 3 L ints, L = 2S + 1."""
    L = 2 * S + 1
    return (14 + 3) * L * 4 if backward else (10 + 2) * L * 4


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-example negative log-likelihood [B] of CUDA log_probs [T, B, V]
    float32 (any strides), labels [B, S] and the lengths [B] (any integer
    dtype; moved to log_probs' card as int32), as
    `ops/ctc_loss.py::ctc_loss_plain` computes it. Differentiable in
    log_probs."""
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_loss: the kernels take CUDA tensors, got "
                         f"{log_probs.device}")
    if log_probs.dtype != torch.float32 or log_probs.ndim != 3:
        raise ValueError(f"ctc_loss: log_probs must be float32 [T, B, V], "
                         f"got {log_probs.dtype} {tuple(log_probs.shape)}")
    T, B, V = log_probs.shape
    if B < 1 or labels.ndim != 2 or labels.shape[0] != B or \
            labels.shape[1] < 1:
        raise ValueError(f"ctc_loss: labels must be [B={B}, S >= 1], got "
                         f"{tuple(labels.shape)}")
    if tuple(input_lengths.shape) != (B,) or \
            tuple(label_lengths.shape) != (B,):
        raise ValueError("ctc_loss: input_lengths and label_lengths must "
                         f"be [B={B}]")
    S = labels.shape[1]
    if T < 1 or not 0 <= blank_id < V:
        raise ValueError(f"ctc_loss: T={T}, blank_id={blank_id}, V={V}")
    if smem_bytes(S, True) > SMEM_MAX:
        raise ValueError(f"ctc_loss: S={S} labels need "
                         f"{smem_bytes(S, True)} bytes of shared memory, "
                         f"more than a block's {SMEM_MAX}")
    dev = log_probs.device
    return _CTCLoss.apply(log_probs, _ints(labels, dev),
                          _ints(input_lengths, dev),
                          _ints(label_lengths, dev), int(blank_id))
