"""The port's FLOP counts (`gasr_tpu_torch/runtime/flops.py`) against the
JAX package's `gasr_tpu/runtime/flops.py`: analytic functions of the
config, equal to JAX's for every preset, exactly; and the card's peak."""

import pytest
import torch

from gasr_tpu.config import PRESETS as JPRESETS
from gasr_tpu.runtime import flops as jflops

from gasr_tpu_torch.config import PRESETS
from gasr_tpu_torch.runtime import flops as tflops


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_flops_match_jax_for_every_preset(name):
    assert sorted(PRESETS) == sorted(JPRESETS)
    cfg, jcfg = PRESETS[name], JPRESETS[name]
    assert tflops.model_fwd_flops(cfg) == jflops.model_fwd_flops(jcfg) > 0
    assert tflops.model_train_flops(cfg) == \
        jflops.model_train_flops(jcfg) == 3 * tflops.model_fwd_flops(cfg)


def test_device_peak_flops(monkeypatch):
    assert tflops.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "NVIDIA H100 80GB HBM3")
    assert tflops.device_peak_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "Some Other Card")
    assert tflops.device_peak_flops() is None
