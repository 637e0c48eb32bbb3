"""The port's graft entries (`gasr_tpu_torch/graft_entry.py`): `entry`'s
forward against the JAX package's `__graft_entry__.entry` on carried
params, and `dryrun_multichip` over gloo ranks on the CPU.

Tolerance: FWD_ATOL, the 512-wide float32 forward's log-probs against
XLA's on the CPU: the same float32 ops, summed in other orders over 100
recurrence steps.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from gasr_tpu_torch import graft_entry
from gasr_tpu_torch.runtime.checkpoint import params_from_jax

FWD_ATOL = 1e-4


def test_entry_matches_jax_entry_on_carried_params():
    jfn, (jp, jx) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jp, jx))
    fn, (params, x) = graft_entry.entry(device="cpu")
    assert x.shape == tuple(jx.shape) == (32, 100, 78)
    assert {k: tuple(v["w"].shape) for k, v in params.items()
            if "w" in v} == {k: tuple(v["w"].shape) for k, v in jp.items()
                              if "w" in v}
    got = fn(params_from_jax(jax.device_get(jp)),
             torch.from_numpy(np.array(jx)))
    assert got.shape == want.shape == (100, 32, 47)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


def test_entry_and_dryrun_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(1)


def test_dryrun_multichip_four_gloo_ranks(capsys):
    graft_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 4}" in out
    for line in ("TP(4) fused_frame beam search bit-equal",
                 "TP(4) whole-scan kernel bit-equal",
                 "TP(4) STREAMING chunk sequence bit-equal",
                 "conformer_l: sharded fwd + TP fused decode parity OK"):
        assert line in out, line
