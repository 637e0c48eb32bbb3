"""The plain reference (`asrbench/reference/`) held to the program at tiny
sizes on the CPU, on weights made by `asrbench/weights.py`.

Tolerances:
  F32   float32 forwards: the same products in another order (the
        reference's relative term is gathered, the program's shifted).
  exact the decoders: the reference is a copy of the algorithm the
        program states, so tokens are equal and scores equal to the bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from asrbench import judge
from asrbench import weights as wmod
from asrbench.reference import conformer as rconf
from asrbench.reference import decoder as rdec
from asrbench.reference import deepspeech as rds
from asrbench.reference.precision import round_to
from asrbench.tests._tiny import tiny_cell

from gasr_tpu_torch.decoder import ctc_beam_search
from gasr_tpu_torch.decoder.beam_search import (decode_to_lists,
                                                streaming_init,
                                                streaming_step)
from gasr_tpu_torch.models import model_init
from gasr_tpu_torch.models.conformer import conformer_apply
from gasr_tpu_torch.models.deepspeech import deepspeech_apply
from gasr_tpu_torch.runtime._tree import tensors
from gasr_tpu_torch.train import make_optimizer, make_train_step

F32 = 2e-5
ROOT = Path(__file__).resolve().parents[2]


def _cfg(cell):
    from asrbench.common import program_config
    return program_config(cell, "cpu")


def _weights(cell, seed=3):
    return wmod.make(cell.config["family"], cell.config["model"],
                     torch.Generator().manual_seed(seed), "cpu")


def _x(cfg, B, T, seed=5):
    return torch.rand((B, T, cfg.feat_size),
                      generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("cell", ["ds1_batch", "conformer_l_batch"])
def test_weights_have_the_program_layout(cell):
    c = tiny_cell(cell)
    cfg = _cfg(c)
    ours = wmod.leaves(_weights(c))
    theirs = wmod.leaves(model_init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    assert [(n, tuple(t.shape)) for n, t in ours] == \
        [(n, tuple(t.shape)) for n, t in theirs]


def test_weights_are_the_seeds():
    c = tiny_cell("conformer_l_batch")
    a, b = _weights(c, 7), _weights(c, 7)
    for (_, x), (_, y) in zip(wmod.leaves(a), wmod.leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(wmod.leaves(_weights(c, 8))[0][1],
                           wmod.leaves(a)[0][1])


def test_deepspeech_reference_matches_the_float32_program():
    c = tiny_cell("ds1_batch")
    cfg = _cfg(c)
    p = _weights(c)
    x = _x(cfg, 8, 30)
    with torch.no_grad():
        got = deepspeech_apply(p, x, rnn_impl="scan")
    want = rds.forward(p, x, {"linear": "f32", "recurrence": "f32"})
    assert (got - want).abs().max() < F32


def test_deepspeech_reference_bf16_recurrence_is_the_kernels_rounding():
    c = tiny_cell("ds1_batch")
    cfg = _cfg(c)
    p = _weights(c)
    x = _x(cfg, 8, 30)
    with torch.no_grad():
        got = deepspeech_apply(p, x, rnn_impl="pallas")
    want = rds.forward(p, x, c.config["reference_precision"]["batch"])
    assert (got - want).abs().max() < F32


def test_conformer_reference_matches_the_float32_program():
    c = tiny_cell("conformer_l_batch")
    cfg = _cfg(c)
    p = _weights(c)
    x = _x(cfg, 3, 48)
    with torch.no_grad():
        got = conformer_apply(cfg, p, x, compute_dtype=None, attn_impl="xla",
                              stem_impl="xla")
        want = rconf.forward(p, x, c.config["model"]["num_heads"], "f32")
    assert got.shape == want.shape
    assert (got - want).abs().max() < F32


def test_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, 3.0, -0.3])
    assert round_to(x, "tf32")[0] == 1.0 + 2 ** -10   # a tie, away
    assert round_to(x, "tf32")[1] == 1.0
    assert round_to(x, "bf16")[0] == 1.0
    assert torch.equal(round_to(x, "f32"), x)
    q = round_to(x, "fp8")
    assert (q - x).abs().max() <= 3.0 * 2 ** -4 and not torch.equal(q, x)


def _log_probs(B, T, V, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.log_softmax(3 * torch.randn(T, B, V, generator=g), -1)


@pytest.mark.parametrize("seed", [1, 2])
def test_decoder_reference_equals_the_programs_decoder(seed):
    lp = _log_probs(6, 25, 9, seed)
    res = decode_to_lists(ctc_beam_search(lp, beam_width=5, max_len=32))
    ref = rdec.decode(lp, 5, [25], max_len=32)[25]
    assert [t for t, _ in res] == [t for t, _ in ref]
    assert [s for _, s in res] == [s for _, s in ref]


@pytest.mark.parametrize("seed", [1, 2])
def test_decoder_reference_with_lengths_equals_the_programs(seed):
    lp = _log_probs(6, 25, 9, seed)
    lens = torch.tensor([25, 3, 17, 1, 24, 10], dtype=torch.int32)
    res = decode_to_lists(ctc_beam_search(lp, beam_width=5, max_len=32,
                                          input_lengths=lens))
    ref = rdec.decode(rdec.pad_blank(lp, lens, 0), 5, [25], max_len=32)[25]
    assert [t for t, _ in res] == [t for t, _ in ref]
    assert [s for _, s in res] == [s for _, s in ref]


def test_decoder_reference_snapshots_equal_the_programs_stream():
    lp = _log_probs(4, 30, 7, 3)
    st = streaming_init(4, 6, 32, device="cpu")
    parts = []
    for c in range(3):
        st, snap = streaming_step(st, lp[10 * c:10 * (c + 1)])
        parts.append(decode_to_lists(snap))
    ref = rdec.decode(lp, 6, [10, 20, 30], max_len=32)
    for c in range(3):
        assert parts[c] == [(t, s) for t, s in ref[10 * (c + 1)]]


def test_train_reference_matches_the_float32_step():
    c = tiny_cell("conformer_l_train")
    cfg = _cfg(c)
    p = _weights(c)
    g = torch.Generator().manual_seed(4)
    batches = [{"inputs": torch.rand((4, 48, 80), generator=g),
                "labels": torch.randint(1, 17, (4, 6), generator=g,
                                        dtype=torch.int32),
                "input_lengths": torch.full((4,), 48, dtype=torch.int32),
                "label_lengths": torch.tensor([3, 6, 4, 5],
                                              dtype=torch.int32)}
               for _ in range(3)]
    start = [t.clone() for _, t in wmod.leaves(p)]
    ref = judge.reference_steps(c.config, wmod.with_leaves(p, start),
                                batches, "f32")
    opt = make_optimizer(**{"learning_rate": 3e-4, "weight_decay": 1e-6})
    state = opt.init(p)
    step = make_train_step(cfg, opt, attn_impl="xla", stem_impl="xla")
    losses = []
    for b in batches:
        _, _, m = step(p, state, b)
        losses.append(float(m["loss"]))
    assert torch.allclose(torch.tensor(losses, dtype=torch.float64),
                          ref["losses"].double(), rtol=1e-5)
    moved = torch.stack([torch.linalg.vector_norm(a.detach() - b)
                         for a, b in zip(tensors(p), start)])
    assert torch.allclose(moved.double(), ref["update_norms"].double(),
                          rtol=1e-3, atol=1e-7)


def test_a_reference_step_from_the_programs_state_matches_its_step():
    """The window's last step: the reference, from the parameters and
    AdamW moments the program began it with, takes the step the
    program's float32 step takes."""
    c = tiny_cell("conformer_l_train")
    cfg = _cfg(c)
    p = _weights(c)
    g = torch.Generator().manual_seed(6)

    def batch():
        return {"inputs": torch.rand((4, 48, 80), generator=g),
                "labels": torch.randint(1, 17, (4, 6), generator=g,
                                        dtype=torch.int32),
                "input_lengths": torch.tensor([12, 10, 11, 12],
                                              dtype=torch.int32),
                "label_lengths": torch.tensor([3, 6, 4, 5],
                                              dtype=torch.int32)}
    opt = make_optimizer(**c.config["optimizer"])
    state = opt.init(p)
    step = make_train_step(cfg, opt, attn_impl="xla", stem_impl="xla")
    for _ in range(3):
        step(p, state, batch())
    leaves = list(tensors(p))
    st = [state.state[t] for t in leaves]
    snap = {"p": [t.detach().clone() for t in leaves],
            "m": [s["exp_avg"].clone() for s in st],
            "v": [s["exp_avg_sq"].clone() for s in st],
            "t": int(st[0]["step"]), "b1": 0.9}
    last = batch()
    _, _, m = step(p, state, last)
    got = judge.program_step(snap, {"p": leaves, "loss": m["loss"],
                                    "grad_norm": m["grad_norm"],
                                    "m": [s["exp_avg"] for s in st]})
    ref = judge.step_from(c.config, p, snap, last, "f32")
    nums = judge.timed_numbers(got, ref)
    assert nums["last_loss_gap"] < 1e-5
    assert nums["last_grad_norm_gap"] < 1e-5
    assert nums["last_grad_gap"] < 1e-4
    assert nums["last_update_gap"] < 1e-3


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, asrbench.reference.deepspeech, "
            "asrbench.reference.conformer, asrbench.reference.decoder, "
            "asrbench.reference.train, asrbench.reference.precision, "
            "asrbench.reference.spec; from asrbench import reference; "
            "reference.family('deepspeech'); reference.family('conformer'); "
            "from asrbench import guard; "
            "bad = guard.found(forbidden=guard.FORBIDDEN + (guard.PROGRAM,)); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
