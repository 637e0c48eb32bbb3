"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach (ragged sizes, envelope
corners, short runs). Marked `cuda`; every test skips without a card.

This file imports no JAX, so on a machine without JAX it runs as
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.ops.cuda import fused_decode, rnn_scan, topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("B,N,k", [(3, 5, 5), (2, 1000, 1), (4, 4097, 128),
                                   (1, 16384, 100), (2, 70001, 64)])
def test_topk_kernel_equals_plain(dev, B, N, k):
    rng = np.random.default_rng(N)
    x = np.round(rng.standard_normal((B, N)) * 2).astype(np.float32)
    x[0, ::3] = -0.0
    xt = torch.from_numpy(x).to(dev)
    kv, ki = topk.topk(xt, k)
    pv, pi = topk.topk_plain(xt, k)
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def test_topk_kernel_rejects_out_of_range(dev):
    with pytest.raises(ValueError):
        topk.topk(torch.zeros(2, 300, device=dev), 129)
    with pytest.raises(ValueError):
        topk.topk(torch.zeros(2, 8, device=dev), 9)


@pytest.mark.parametrize("W,V,T,B,blank", [
    (128, 128, 5, 3, 0),       # the TPU kernel's first envelope corner
    (64, 256, 5, 2, 0),        # its second
    (1, 5, 9, 2, 0),
    (7, 3, 12, 5, 2),          # blank not at 0
    (100, 47, 1, 1, 0),
])
@pytest.mark.parametrize("kind", ["random", "relu"])
def test_decode_and_traceback_kernels_equal_plain(dev, W, V, T, B, blank,
                                                  kind):
    rng = np.random.default_rng(W * V + T)
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    lp = (_log_softmax(x) if kind == "random"
          else np.maximum(np.round(x * 2) / 2, 0.0).astype(np.float32))
    lp = torch.from_numpy(lp).to(dev)
    init = tbs._init_beam(B, W, dev)
    fin_k, ys_k = fused_decode.fused_prefix_decode(lp, init, blank)
    fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp, init, blank)
    assert torch.equal(ys_k, ys_p)
    for f in fused_decode.FIELDS:
        a, b = getattr(fin_k, f), getattr(fin_p, f)
        assert torch.equal(a.to(b.dtype), b), f
    for L in (3, 16):
        for a, b in zip(fused_decode.traceback(ys_k, fin_k.length, L),
                        fused_decode.traceback_plain(ys_k, fin_k.length, L)):
            assert torch.equal(a, b)


def test_decode_kernel_outside_envelope_raises(dev):
    lp = torch.zeros(2, 1, 129, device=dev)
    with pytest.raises(ValueError, match="envelope"):
        tbs.ctc_beam_search(lp, beam_width=128)
    # the eager scan stays available on the card by explicit request
    res = tbs.ctc_beam_search(lp, beam_width=128, merge_impl="matched")
    assert res.tokens.shape == (1, 128, 256)


def test_ctc_beam_search_input_lengths_kernel_equals_plain(dev):
    rng = np.random.default_rng(3)
    lp = torch.from_numpy(_log_softmax(
        rng.standard_normal((30, 4, 29)))).to(dev)
    lens = torch.tensor([30, 17, 5, 1], device=dev)
    a = tbs.ctc_beam_search(lp, beam_width=16, max_len=12,
                            input_lengths=lens)
    b = tbs.ctc_beam_search(lp, beam_width=16, max_len=12,
                            input_lengths=lens, merge_impl="matched")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("T,B,H,reverse", [(4, 3, 100, False),
                                           (3, 70, 130, True),
                                           (2, 1, 1, False)])
def test_rnn_scan_kernel_close_to_plain(dev, T, B, H, reverse):
    rng = np.random.default_rng(B * H)
    xw = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (H, H)) / H ** 0.5).astype(
        np.float32)).to(dev)
    h0 = torch.tanh(torch.from_numpy(rng.standard_normal((B, H)).astype(
        np.float32))).to(dev)
    got = rnn_scan.rnn_scan(xw, w, h0, reverse=reverse)
    want = rnn_scan.rnn_scan_plain(xw, w, h0, reverse=reverse)
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3


def test_rnn_scan_kernel_rejects_float32_weights(dev):
    with pytest.raises(ValueError, match="bf16"):
        rnn_scan.rnn_scan(torch.zeros(1, 2, 4, device=dev),
                          torch.zeros(4, 4, device=dev),
                          torch.zeros(2, 4, device=dev),
                          weight_dtype=torch.float32)
