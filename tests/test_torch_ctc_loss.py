"""The port's CTC loss (`gasr_tpu_torch/ops/ctc_loss.py`) against the JAX
package's `ctc_loss` and against `torch.nn.functional.ctc_loss`, loss and
d loss / d log_probs, on numpy-seeded inputs; the kernel pair's algorithm
(`csrc/ctc_loss.cu`), emulated in PyTorch on the CPU, against the plain
version's autograd; and, marked `cuda`, the kernel pair on the card
against the plain version on the card.

Tolerances:
  LOSS_RTOL  against JAX: the same float32 expressions in the same order;
             torch's and XLA's exp / log1p may differ in the last bit. The
             kernel pair and its emulation against the plain version: the
             same expressions, exp and log from another library.
  GRAD_ATOL  against JAX: the same, accumulated through the T-step
             backward and the emission gather's scatter-add (the JAX
             package sums the same terms by a one-hot product). The kernel
             pair and its emulation: the same adjoints, summed in another
             order (autograd's accumulation and the gather's scatter-add
             against the kernel's fixed order).
  Against F.ctc_loss the tolerances of tests/test_ctc_loss.py, which
  holds the JAX package to it (another algorithm: torch's own recursion
  and its backward).

The emulation follows the kernels state by state: the forward's states
k < E from the emissions, alpha kept per frame; the backward's adjoint of
each state's lse3 (`_lse3_adjoint`: torch.maximum's gradient shares, the
-80 floor's mask) split into the three arrays ga, gb, gc that the next
frame sums as ga[k] + gb[k+1] + gc[k+2]; the fold of each frame's
emission adjoints by symbol: the blank's even states as 32 lanes' partial
sums in increasing k and a butterfly over the lanes, then its odd states;
each label's odd states in increasing k. The card tests' file imports no
JAX at the top (the card's machine has none); the JAX tests import it
where they call it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gasr_tpu_torch.ops.ctc_loss import NEG_INF, ctc_loss, ctc_loss_plain
from gasr_tpu_torch.ops.cuda import ctc_loss as kctc

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
    import jax
    import jax.numpy as jnp

    from gasr_tpu.ops.ctc_loss import ctc_loss as j_ctc_loss
    args = (jnp.asarray(labels), jnp.asarray(in_len), jnp.asarray(lab_len))
    loss = j_ctc_loss(jnp.asarray(lp), *args)
    grad = jax.grad(lambda a: jnp.sum(j_ctc_loss(a, *args) * w))(
        jnp.asarray(lp))
    return np.asarray(loss), np.asarray(grad)


def _port(lp, labels, in_len, lab_len, w, fn=ctc_loss):
    t = torch.tensor(lp, requires_grad=True)
    loss = fn(t, torch.from_numpy(labels), torch.from_numpy(in_len),
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


def _ties_case():
    """Example 0 feasible, example 1 (labels 1, 1, 1 in 3 frames: 5 needed)
    not, uniform log-probs."""
    T, B, V = 3, 2, 4
    lp = np.full((T, B, V), np.log(0.25), np.float32)
    labels = np.array([[1, 2, 3], [1, 1, 1]], np.int32)
    lab_len = np.array([3, 3], np.int32)
    in_len = np.array([3, 3], np.int32)
    return lp, labels, in_len, lab_len


def test_gradient_splits_at_ties():
    """Unreachable states hold NEG_INF, so max(a, b, c) ties there and at
    the final max(out, NEG_INF). JAX's maximum gives each side half the
    gradient at a tie, and so does torch.maximum; a clamp would give one
    side all of it. An infeasible example has a gradient only through
    those ties: its grad must still equal JAX's."""
    lp, labels, in_len, lab_len = _ties_case()
    w = np.ones(lp.shape[1], np.float32)
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


def test_cpu_tensors_take_the_plain_version():
    """`ctc_loss` on CPU tensors is `ctc_loss_plain`, loss and gradient bit
    for bit, and launches no kernel."""
    lp, labels, in_len, lab_len = _case(**CASES["random_wide"])
    w = np.array([0.5, -2.0, 1.25], np.float32)
    n0 = kctc.launches
    got = _port(lp, labels, in_len, lab_len, w)
    want = _port(lp, labels, in_len, lab_len, w, fn=ctc_loss_plain)
    assert kctc.launches == n0
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ---- the kernel pair's algorithm, emulated on the CPU

def _mx(a, b):
    """torch.maximum as the kernels write it: the larger, NaN if a is."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def _share(x, y, g, tie_half=True):
    """torch.maximum's backward: g to x above y, half at a tie, 0 below
    (tie_half=False: all of it at a tie, as a clamp would give)."""
    return torch.where(x < y, torch.zeros_like(g),
                       torch.where(x == y, g * 0.5 if tie_half else g, g))


def _term(d):
    return torch.where(d > -80.0, torch.exp(d), torch.zeros_like(d))


def _lse3(a, b, c):
    m = _mx(_mx(a, b), c)
    ms = _mx(m, torch.full_like(m, NEG_INF))
    s = ((_term(a - ms) + _term(b - ms)) + _term(c - ms)) + 1e-37
    return _mx(m + torch.log(s), torch.full_like(m, NEG_INF))


def _lse3_adjoint(a, b, c, g, tie_half=True):
    neg = torch.full_like(a, NEG_INF)
    ab = _mx(a, b)
    m = _mx(ab, c)
    ms = _mx(m, neg)
    ea, eb, ec = _term(a - ms), _term(b - ms), _term(c - ms)
    s = ((ea + eb) + ec) + 1e-37
    gout = _share(m + torch.log(s), neg, g, tie_half)
    gs = gout / s
    gda, gdb, gdc = gs * ea, gs * eb, gs * ec
    gm = gout + _share(m, neg, (-gda - gdb) - gdc, tie_half)
    gab = _share(ab, c, gm, tie_half)
    return (gda + _share(a, b, gab, tie_half),
            gdb + _share(b, a, gab, tie_half),
            gdc + _share(c, ab, gm, tie_half))


def _shift(x, n, fill):
    """x[:, k - n] (fill below 0) for n > 0, x[:, k + |n|] (fill past the
    end) for n < 0."""
    pad = torch.full_like(x[:, :abs(n)], fill)
    if n > 0:
        return torch.cat([pad, x[:, :-n]], 1)
    return torch.cat([x[:, -n:], pad], 1)


def emulate_pair(lp, labels, in_len, lab_len, gloss, blank=0,
                 tie_half=True):
    """The kernels' loss [B] and d (sum gloss * loss) / d lp [T, B, V],
    state by state (float32 tensors)."""
    T, B, V = lp.shape
    S = labels.shape[1]
    L = 2 * S + 1
    k = torch.arange(L)
    odd = k % 2 == 1
    lab = labels.long()
    z = torch.where(odd, lab[:, (k // 2).clamp(max=S - 1)],
                    torch.full((), blank))                         # [B, L]
    prev_lab = lab[:, (k // 2 - 1).clamp(0, S - 1)]
    skip = odd & (k >= 2) & (z != prev_lab)
    E = (2 * lab_len.long() + 1)[:, None]
    valid = k < E                                                  # [B, L]
    neg = torch.full((B, L), NEG_INF)
    alpha = []
    for t in range(T):
        real = (t < in_len.long())[:, None]
        e = torch.where(real, lp[t].gather(1, z.clamp(0, V - 1)),
                        torch.where(z == blank, 0.0, NEG_INF))
        if t == 0:
            v = torch.where(k < 2, 0.0, NEG_INF) + e
        else:
            cur = alpha[-1]
            v = _lse3(cur, _shift(cur, 1, NEG_INF),
                      torch.where(skip, _shift(cur, 2, NEG_INF), neg)) + e
        alpha.append(torch.where(valid, v, neg))
    last_row = alpha[-1]
    last = last_row.gather(1, E - 1)[:, 0]
    last2 = torch.where(E[:, 0] >= 2,
                        last_row.gather(1, (E - 2).clamp(min=0))[:, 0],
                        torch.full((B,), NEG_INF))
    nb = torch.full((B,), NEG_INF)
    loss = -_lse3(last, last2, nb)

    ja, jb, _ = _lse3_adjoint(last, last2, nb, -gloss, tie_half)
    jb = torch.where(E[:, 0] >= 2, jb, torch.zeros_like(jb))
    ga = torch.where(k == E - 1, ja[:, None],
                     torch.where(k == E - 2, jb[:, None], 0.0))
    gb = torch.zeros(B, L)
    gc = torch.zeros(B, L)
    ge = torch.zeros(T, B, L)
    for t in range(T - 1, -1, -1):
        g = torch.where(valid, (ga + _shift(gb, -1, 0.0))
                        + _shift(gc, -2, 0.0), 0.0)
        ge[t] = g
        if t == 0:
            break
        row = alpha[t - 1]
        oa, ob, oc = _lse3_adjoint(
            row, _shift(row, 1, NEG_INF),
            torch.where(skip, _shift(row, 2, NEG_INF), neg), g, tie_half)
        ga = torch.where(valid, oa, 0.0)
        gb = torch.where(valid & (k >= 1), ob, 0.0)
        gc = torch.where(valid & skip, oc, 0.0)

    # the fold, by symbol, in the kernel's order
    grad = torch.zeros(T, B, V)
    for b in range(B):
        Eb = int(E[b, 0])
        zb = z[b].tolist()
        for t in range(min(int(in_len[b]), T)):
            g = ge[t, b]
            lanes = torch.zeros(32)
            for lane in range(32):
                for kk in range(2 * lane, Eb, 64):
                    lanes[lane] = lanes[lane] + g[kk]
            for o in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[torch.arange(32) ^ o]
            total = lanes[0]
            for kk in range(1, Eb, 2):
                if zb[kk] == blank:
                    total = total + g[kk]
            grad[t, b, blank] = total
            done = set()
            for kk in range(1, Eb, 2):
                if zb[kk] == blank or zb[kk] in done:
                    continue
                done.add(zb[kk])
                s = g[kk]
                for jj in range(kk + 2, Eb, 2):
                    if zb[jj] == zb[kk]:
                        s = s + g[jj]
                grad[t, b, zb[kk]] = s
    return loss, grad


def _plain_pair(lp, labels, in_len, lab_len, gloss):
    t = lp.clone().requires_grad_()
    loss = ctc_loss_plain(t, labels, in_len, lab_len)
    loss.backward(gloss)
    return loss.detach(), t.grad


EMULATED = {**CASES,
            "blank_label": dict(seed=6, T=14, B=2, V=5, S=4,
                                labels=[[2, 0, 0, 3], [0, 1, 0, 1]],
                                lab_len=[4, 3]),
            "one_frame": dict(seed=7, T=9, B=3, V=5, S=2,
                              in_len=[1, 1, 9], lab_len=[0, 1, 2]),
            "blank_tree": dict(seed=8, T=8, B=1, V=4, S=40,
                               labels=[[1, 2] * 20], lab_len=[40],
                               in_len=[8])}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_emulated_kernel_pair_matches_plain(name):
    """The kernels' expressions and order, state by state, give the plain
    version's loss and autograd gradient (a random d loss), also with
    labels equal to the blank, one-frame inputs and a blank with more than
    32 even states (two per lane)."""
    lp, labels, in_len, lab_len = map(torch.from_numpy,
                                      _case(**EMULATED[name]))
    gloss = torch.from_numpy(np.random.default_rng(len(name)).standard_normal(
        lp.shape[1]).astype(np.float32))
    want_loss, want_grad = _plain_pair(lp, labels, in_len, lab_len, gloss)
    loss, grad = emulate_pair(lp, labels, in_len, lab_len, gloss)
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=GRAD_ATOL)


def test_emulated_pair_needs_the_tie_halves():
    """The adjoint that gives a tie all of the gradient, not half, misses
    the plain version's gradient of the infeasible example."""
    lp, labels, in_len, lab_len = map(torch.from_numpy, _ties_case())
    gloss = torch.ones(2)
    _, want = _plain_pair(lp, labels, in_len, lab_len, gloss)
    _, halves = emulate_pair(lp, labels, in_len, lab_len, gloss)
    _, whole = emulate_pair(lp, labels, in_len, lab_len, gloss,
                            tie_half=False)
    torch.testing.assert_close(halves, want, rtol=0, atol=GRAD_ATOL)
    assert (whole - want).abs().max() > 0.04


def test_smem_bytes_fits_the_training_shapes():
    """The kernels' shared memory (`smem_bytes`, csrc/ctc_loss.cu's
    forward_smem / backward_smem) fits a block at the training cell's S =
    97 and up to S = 1700; the wrapper refuses past it."""
    assert kctc.smem_bytes(97, True) == 17 * 195 * 4
    assert kctc.smem_bytes(97, False) == 12 * 195 * 4
    assert kctc.smem_bytes(1700, True) <= kctc.SMEM_MAX
    assert kctc.smem_bytes(1709, True) > kctc.SMEM_MAX


def test_kernel_wrapper_refuses_on_the_cpu():
    lp = torch.zeros(4, 2, 5)
    ones = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kctc.ctc_loss(lp, torch.ones(2, 3, dtype=torch.int32), ones, ones)


# ---- the kernel pair on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cell_case(seed):
    """The training cell's shape: T' = 300, B = 64, V = 129, S = 97, input
    lengths 275-300, label lengths 44-96, labels uniform in [1, 128]."""
    rng = np.random.default_rng(seed)
    T, B, V, S = 300, 64, 129, 97
    x = rng.standard_normal((T, B, V)).astype(np.float32) * 2
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return (lp, rng.integers(1, V, (B, S)).astype(np.int32),
            rng.integers(275, 301, B).astype(np.int32),
            rng.integers(44, 97, B).astype(np.int32))


CARD_CASES = {
    "cell": lambda: _cell_case(11),
    "empty_labels": lambda: _case(**CASES["empty_labels"]),
    "repeats": lambda: _case(12, T=40, B=3, V=7, S=6,
                             labels=[[4] * 6, [1] * 6, [6] * 6],
                             lab_len=[6, 6, 3], in_len=[40, 13, 9]),
    "infeasible": lambda: _case(**CASES["infeasible"]),
    "input_length_1": lambda: _case(13, T=10, B=4, V=6, S=3,
                                    lab_len=[0, 1, 2, 0],
                                    in_len=[1, 1, 1, 10]),
    # L = 601 states > MAX_THREADS: two a thread
    "wide": lambda: _case(14, T=650, B=3, V=40, S=300),
    "blank_label": lambda: _case(**EMULATED["blank_label"]),
}


def _card_pair(lp, labels, in_len, lab_len, gloss, fn, transpose=False):
    if transpose:
        # the [T, B, V] view of a [B, T, V] tensor
        base = lp.transpose(0, 1).contiguous().clone().requires_grad_()
        t = base.transpose(0, 1)
    else:
        base = t = lp.clone().requires_grad_()
    loss = fn(t, labels, in_len, lab_len)
    loss.backward(gloss)
    return loss.detach(), base.grad.transpose(0, 1) if transpose \
        else base.grad


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_pair_matches_plain_on_card(dev, name, transpose):
    """The kernels' loss (rtol 1e-5) and d loss / d log_probs (atol 1e-5,
    a random d loss) against the plain version's autograd, both on the
    card; log_probs contiguous or a transposed view."""
    lp, labels, in_len, lab_len = (torch.from_numpy(a).to(dev)
                                   for a in CARD_CASES[name]())
    gloss = torch.from_numpy(np.random.default_rng(len(name)).standard_normal(
        lp.shape[1]).astype(np.float32)).to(dev)
    n0 = kctc.launches
    loss, grad = _card_pair(lp, labels, in_len, lab_len, gloss, ctc_loss,
                            transpose)
    assert kctc.launches == n0 + 2
    want_loss, want_grad = _card_pair(lp, labels, in_len, lab_len, gloss,
                                      ctc_loss_plain)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=GRAD_ATOL)
    assert torch.isfinite(grad).all()


@pytest.mark.cuda
def test_gradient_splits_at_ties_on_card(dev):
    """test_gradient_splits_at_ties through the kernels: the infeasible
    example's gradient, made of the ties' halves, equals the plain
    version's on the card."""
    lp, labels, in_len, lab_len = (torch.from_numpy(a).to(dev)
                                   for a in _ties_case())
    gloss = torch.ones(2, device=dev)
    loss, grad = _card_pair(lp, labels, in_len, lab_len, gloss, ctc_loss)
    want_loss, want_grad = _card_pair(lp, labels, in_len, lab_len, gloss,
                                      ctc_loss_plain)
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=GRAD_ATOL)
    assert loss[1] == -NEG_INF
    assert float(grad[:, 1].abs().max()) > 0.04


@pytest.mark.cuda
def test_kernel_pair_is_deterministic_and_launches_twice(dev):
    """Two calls at the cell's shape give bit-equal losses and gradients;
    a loss and its backward are two launches."""
    lp, labels, in_len, lab_len = (torch.from_numpy(a).to(dev)
                                   for a in _cell_case(15))
    gloss = torch.full((64,), 1 / 64, device=dev)
    n0 = kctc.launches
    first = _card_pair(lp, labels, in_len, lab_len, gloss, ctc_loss)
    assert kctc.launches == n0 + 2
    second = _card_pair(lp, labels, in_len, lab_len, gloss, ctc_loss)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_pair_refuses_on_card(dev):
    lp = torch.zeros(4, 2, 5, device=dev)
    ones = torch.ones(2, dtype=torch.int32, device=dev)
    lab = torch.ones(2, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        ctc_loss(lp.to(torch.bfloat16), lab, ones, ones)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_loss(lp, torch.ones(2, 1800, dtype=torch.int32, device=dev),
                 ones, ones)
    with pytest.raises(ValueError, match="blank_id"):
        ctc_loss(lp, lab, ones, ones, blank_id=5)
    # an out-of-range label length: NaN loss and gradient for its example
    t = lp.clone().requires_grad_()
    loss = ctc_loss(t, lab, ones, torch.tensor([1, 4], dtype=torch.int32,
                                               device=dev))
    loss.sum().backward()
    assert torch.isfinite(loss[0]) and torch.isnan(loss[1])
    assert torch.isfinite(t.grad[:, 0]).all() and torch.isnan(
        t.grad[:, 1]).all()
