"""The cells added after the first benchmark, at tiny sizes on the CPU.

The FastConformer family (`reference/fastconformer.py`, cell
`parakeet_ctc_batch`): a whole run comes out correct, untraced and
traced; the control at the configuration's control precision does not;
nor does a run with a planted fault (a transcript's token altered). The
tiny cut moves blank to the end of the cut vocabulary, as the
configuration has it.

The data-parallel training cell (`loops/train_dp.py`, cell
`ds1_train_dp4`) on four gloo ranks, this process rank 0 and three
followers: a whole run comes out correct and reports four devices; the
control and each fault in the reference in the program's place fail the
limits; and each fault planted in the program's step, on every rank it
breaks, comes out not correct."""

import pytest

import gasr_tpu_torch.decoder.beam_search as bs

from asrbench import harness
from asrbench.loops import train_dp
from asrbench.reference import fastconformer
from asrbench.tests import _dp_faults
from asrbench.tests._tiny import tiny_cell
from asrbench.tests.test_asrbench_faults import _altered_lists

SEED = 2 ** 31 + 23
DP = "ds1_train_dp4"


def _run(name, traced=False, after=None):
    return harness.run(tiny_cell(name), SEED, 0.3, traced, "cpu",
                       log=lambda m: None, after=after)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["parakeet_ctc_batch", DP])
def test_a_new_cell_runs_end_to_end_on_the_cpu(cell, traced):
    r = _run(cell, traced)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and list(r)[-1] == "checks"
    assert r["device"]["count"] == tiny_cell(cell).chips
    if traced:
        assert r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == {m["name"] for m in
                                     tiny_cell(cell).end_to_end}


@pytest.mark.parametrize("cell", ["parakeet_ctc_batch", DP])
def test_the_control_fails_a_new_cells_limits(cell):
    got = {}
    r = _run(cell, after=lambda load, params: got.update(
        load.control_numbers(params)))
    assert r["correct"], r["checks"]
    limits = tiny_cell(cell).limits["limits"]
    over = {k: v for k, v in got.items() if k in limits and v > limits[k]}
    assert over, (got, limits)


def test_each_fault_in_the_references_place_fails_the_dp_cells_limits():
    got = {}
    r = _run(DP, after=lambda load, params: got.update(
        load.fault_numbers(params)))
    assert r["correct"], r["checks"]
    assert sorted(got) == sorted(_dp_faults.FAULTS)
    limits = tiny_cell(DP).limits["limits"]
    for fault, vals in got.items():
        over = {k: v for k, v in vals.items()
                if k in limits and v > limits[k]}
        assert over, (fault, vals, limits)


FAULTS = {
    "token": ("parakeet_ctc_batch",
              [(bs, "decode_to_lists", _altered_lists)]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_in_a_new_cell_is_not_correct(fault, monkeypatch):
    cell, patches = FAULTS[fault]
    for owner, name, make in patches:
        monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", _dp_faults.FAULTS)
def test_a_fault_planted_in_the_data_parallel_step_is_not_correct(
        fault, monkeypatch):
    _dp_faults.plant(fault, monkeypatch.setattr)
    monkeypatch.setattr(train_dp, "FOLLOW",
                        _dp_faults.follower_code(fault, train_dp.FOLLOW))
    r = _run(DP)
    assert r["device"]["count"] == 4
    assert not r["correct"], r["checks"]


def test_the_familys_frames_and_flops():
    assert [fastconformer.output_frames(n) for n in (1, 7, 8, 9, 6000)] == \
        [1, 1, 1, 2, 750]
    m = dict(feat_size=80, d_model=1024, num_blocks=42, num_heads=8,
             ff_mult=4, conv_kernel=9, stem_channels=256, vocab_size=1024)
    # the stem, 42 blocks and the head: about 2 x 1.07 G multiply-adds a
    # frame, and the attention's T'^2 terms on top
    f = fastconformer.forward_flops(m, 32, 6000)
    assert 50e12 < f < 60e12, f
