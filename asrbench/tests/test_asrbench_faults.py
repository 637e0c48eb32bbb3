"""A whole run (set-up, window, comparison) with the timed path broken
underneath comes out not correct, once for each fault a cell can have:
a transcript's token altered where it is produced; a decode step that
returns its state unchanged; a training step that leaves the parameters
unchanged; half of the batch left out, the mean taken over the rest;
and, training, the last two and a loss that is not finite from the
window's first step on, after three sound steps of set-up. The same run
unbroken comes out correct. At a tiny size on the CPU."""

import pytest

import gasr_tpu_torch.decoder.beam_search as bs
import gasr_tpu_torch.infer as infer
import gasr_tpu_torch.train as train

from asrbench import harness
from asrbench.tests._tiny import tiny_cell

SEED = 2 ** 31 + 21


def _run(cell):
    return harness.run(tiny_cell(cell), SEED, 0.3, False, "cpu",
                       log=lambda m: None)


def _altered_lists(real):
    def lists(result, top=1):
        out = real(result, top)
        tokens, score = out[0]
        first = 2 if tokens[:1] == [1] else 1
        out[0] = ([first] + tokens[1:], score)
        return out
    return lists


def _stuck_step(real):
    def step(state, *a, **kw):
        _, snap = real(state, *a, **kw)
        return state, snap
    return step


def _half_batch_loss(real):
    def loss(log_probs, batch, blank_id=0):
        h = log_probs.shape[1] // 2
        return real(log_probs[:, :h], {k: v[:h] for k, v in batch.items()},
                    blank_id)
    return loss


def _after_warm_up(fault):
    """`fault` from the fourth call on: set-up's three steps are sound,
    the window's are not."""
    def make(real):
        broken, calls = fault(real), [0]

        def f(*a, **kw):
            calls[0] += 1
            return (real if calls[0] <= 3 else broken)(*a, **kw)
        return f
    return make


def _nan_loss(real):
    def loss(log_probs, batch, blank_id=0):
        return real(log_probs, batch, blank_id) * float("nan")
    return loss


def _no_update(real):
    return lambda opt_state, grads, g_norm=None: train.global_norm(
        list(grads))


FAULTS = {
    "token": ("ds1_batch", [(bs, "decode_to_lists", _altered_lists),
                            (infer, "decode_to_lists", _altered_lists)]),
    "token_conformer": ("conformer_l_batch",
                        [(bs, "decode_to_lists", _altered_lists)]),
    "token_stream": ("ds1_stream", [(bs, "decode_to_lists",
                                     _altered_lists)]),
    "state_unchanged_stream": ("ds1_stream", [(bs, "streaming_step",
                                               _stuck_step)]),
    "state_unchanged_train": ("conformer_l_train", [
        (train.Optimizer, "update",
         lambda real: staticmethod(lambda opt_state, grads, g_norm=None:
                                   train.global_norm(list(grads))))]),
    "half_batch_train": ("conformer_l_train", [(train, "batch_loss",
                                                _half_batch_loss)]),
    "half_batch_train_after_warm_up": (
        "conformer_l_train",
        [(train, "batch_loss", _after_warm_up(_half_batch_loss))]),
    "state_unchanged_train_after_warm_up": (
        "conformer_l_train",
        [(train.Optimizer, "update",
          lambda real: staticmethod(_after_warm_up(_no_update)(real)))]),
    "nan_loss_train_after_warm_up": (
        "conformer_l_train",
        [(train, "batch_loss", _after_warm_up(_nan_loss))]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    cell, patches = FAULTS[fault]
    assert _run(cell)["correct"]
    for owner, name, make in patches:
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name, make(real))
    r = _run(cell)
    assert not r["correct"], r["checks"]
