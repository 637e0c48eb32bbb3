"""The control, the reference at the configuration's control precision
(one step below what it states) put in the program's place, comes out
not correct under every cell's limits: at a tiny size on the CPU and on
the card, and for training, whose limits hold the window's last step
after ~25 steps, at the cell's own size on the card. At the tiny size a
training run's bf16 rounding is smaller than at the cell's, so there the
control has to read three times the program's own reading instead."""

import pytest
import torch

from asrbench import harness
from asrbench.manifest import load_cell, load_manifest
from asrbench.tests._tiny import tiny_cell

CELLS = [w["name"] for w in load_manifest()["workloads"]]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell, device):
    c = tiny_cell(cell)
    limits = c.limits["limits"]
    got = {}
    r = harness.run(c, 2 ** 31 + 9, 0.3, False, device, log=lambda m: None,
                    after=lambda load, params: got.update(
                        load.control_numbers(params)))
    assert r["correct"], r["checks"]
    if c.traffic["kind"] == "train":
        own = {k: v["value"] for k, v in r["checks"].items()}
        over = {k: v for k, v in got.items()
                if k in limits and limits[k] and v > 3 * own[k]}
    else:
        over = {k: v for k, v in got.items()
                if k in limits and v > limits[k]}
    assert over, (got, limits)


@pytest.mark.cuda
def test_the_control_fails_the_training_limits_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = load_cell("conformer_l_train")
    limits = c.limits["limits"]
    got = {}
    r = harness.run(c, 2 ** 31 + 19, 30.0, False, "cuda", log=lambda m: None,
                    after=lambda load, params: got.update(
                        load.control_numbers(params)))
    assert r["correct"], r["checks"]
    over = {k: v for k, v in got.items() if k in limits and v > limits[k]}
    assert over, (got, limits)
