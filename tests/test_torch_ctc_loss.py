"""The port's CTC loss (`gasr_tpu_torch/ops/ctc_loss.py`) against the JAX
package's `ctc_loss` and against `torch.nn.functional.ctc_loss`, loss and
d loss / d log_probs, on numpy-seeded inputs.

Tolerances:
  LOSS_RTOL  against JAX: the same float32 expressions in the same order;
             torch's and XLA's exp / log1p may differ in the last bit.
  GRAD_ATOL  against JAX: the same, accumulated through the T-step
             backward and the emission gather's scatter-add (the JAX
             package sums the same terms by a one-hot product).
  Against F.ctc_loss the tolerances of tests/test_ctc_loss.py, which
  holds the JAX package to it (another algorithm: torch's own recursion
  and its backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gasr_tpu.ops.ctc_loss import ctc_loss as j_ctc_loss

from gasr_tpu_torch.ops.ctc_loss import NEG_INF, ctc_loss

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5


def _case(seed, T, B, V, S, lab_len=None, in_len=None, labels=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    if labels is None:
        labels = rng.integers(1, V, (B, S))
    if lab_len is None:
        lab_len = rng.integers(1, S + 1, B)
    if in_len is None:
        in_len = rng.integers(max(2 * S + 1, T // 2), T + 1, B)
    return (lp, np.asarray(labels, np.int32), np.asarray(in_len, np.int32),
            np.asarray(lab_len, np.int32))


def _jax(lp, labels, in_len, lab_len, w):
    """JAX's losses and the grad of sum(w * losses) w.r.t. log_probs."""
    args = (jnp.asarray(labels), jnp.asarray(in_len), jnp.asarray(lab_len))
    loss = j_ctc_loss(jnp.asarray(lp), *args)
    grad = jax.grad(lambda a: jnp.sum(j_ctc_loss(a, *args) * w))(
        jnp.asarray(lp))
    return np.asarray(loss), np.asarray(grad)


def _port(lp, labels, in_len, lab_len, w):
    t = torch.tensor(lp, requires_grad=True)
    loss = ctc_loss(t, torch.from_numpy(labels), torch.from_numpy(in_len),
                    torch.from_numpy(lab_len))
    (loss * torch.from_numpy(w)).sum().backward()
    return loss.detach().numpy(), t.grad.numpy()


CASES = {
    "random": dict(seed=0, T=20, B=4, V=6, S=5),
    "random_wide": dict(seed=1, T=30, B=3, V=29, S=8),
    "repeats": dict(seed=2, T=20, B=2, V=5, S=4,
                    labels=[[1, 1, 2, 2], [3, 3, 3, 3]], lab_len=[4, 4]),
    "empty_labels": dict(seed=3, T=12, B=3, V=5, S=3, lab_len=[0, 2, 0]),
    "short_inputs": dict(seed=4, T=24, B=3, V=7, S=4, in_len=[24, 9, 13]),
    # labels longer than the frames allow: 4 frames cannot emit 1,1,2,2
    # (a repeat needs a blank between), 3 frames cannot emit 5 labels
    "infeasible": dict(seed=5, T=6, B=3, V=6, S=5,
                       labels=[[1, 1, 2, 2, 3], [1, 2, 3, 4, 5],
                               [2, 3, 4, 5, 1]],
                       lab_len=[4, 5, 2], in_len=[4, 3, 6]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ctc_loss_matches_jax(name):
    lp, labels, in_len, lab_len = _case(**CASES[name])
    w = np.arange(1, lp.shape[1] + 1, dtype=np.float32)
    j_loss, j_grad = _jax(lp, labels, in_len, lab_len, w)
    t_loss, t_grad = _port(lp, labels, in_len, lab_len, w)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(t_grad, j_grad, rtol=0, atol=GRAD_ATOL)
    assert np.isfinite(t_grad).all()
    if name == "infeasible":
        # no alignment: the answer is NEG_INF, the loss -NEG_INF
        assert (t_loss[:2] == -NEG_INF).all() and t_loss[2] < 100


def test_gradient_splits_at_ties():
    """Unreachable states hold NEG_INF, so max(a, b, c) ties there and at
    the final max(out, NEG_INF). JAX's maximum gives each side half the
    gradient at a tie, and so does torch.maximum; a clamp would give one
    side all of it. An infeasible example has a gradient only through
    those ties: its grad must still equal JAX's."""
    T, B, V = 3, 2, 4
    lp = np.full((T, B, V), np.log(0.25), np.float32)
    labels = np.array([[1, 2, 3], [1, 1, 1]], np.int32)
    lab_len = np.array([3, 3], np.int32)
    in_len = np.array([3, 3], np.int32)       # b = 1 needs 5 frames
    w = np.ones(B, np.float32)
    j_loss, j_grad = _jax(lp, labels, in_len, lab_len, w)
    t_loss, t_grad = _port(lp, labels, in_len, lab_len, w)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=0, atol=GRAD_ATOL)
    assert t_loss[1] == -NEG_INF
    # the infeasible example's gradient is nonzero, made of those halves
    # (torch.clamp in place of the NEG_INF maxima moves it by 0.12)
    assert np.abs(j_grad[:, 1]).max() > 0.04


@pytest.mark.parametrize("T,B,V,S", [(20, 4, 6, 5), (30, 3, 10, 8),
                                     (15, 2, 29, 4)])
def test_ctc_loss_matches_torch(T, B, V, S):
    """As tests/test_ctc_loss.py holds the JAX package: loss against
    F.ctc_loss (reduction='none'), and the gradient through log_softmax
    of logits against F.ctc_loss's."""
    lp, labels, in_len, lab_len = _case(T * 1000 + S, T, B, V, S)
    got = ctc_loss(torch.from_numpy(lp), torch.from_numpy(labels),
                   torch.from_numpy(in_len), torch.from_numpy(lab_len))
    args = (torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(in_len.astype(np.int64)),
            torch.from_numpy(lab_len.astype(np.int64)))
    want = F.ctc_loss(torch.from_numpy(lp), *args, blank=0,
                      reduction="none", zero_infinity=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=1e-4)

    logits = np.random.default_rng(T + S).standard_normal(
        (T, B, V)).astype(np.float32)
    a = torch.tensor(logits, requires_grad=True)
    ctc_loss(a.log_softmax(-1), torch.from_numpy(labels),
             torch.from_numpy(in_len), torch.from_numpy(lab_len)).sum() \
        .backward()
    b = torch.tensor(logits, requires_grad=True)
    F.ctc_loss(b.log_softmax(-1), *args, blank=0, reduction="sum") \
        .backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-3,
                               atol=1e-4)
