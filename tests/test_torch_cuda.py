"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main paths do not reach (ragged sizes, envelope
corners, short runs, the streaming overlay's overflow and shared
parents), and the decoder's dispatch on CUDA tensors. Marked `cuda`; every test skips without a card.

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


@pytest.mark.parametrize("W,V", [(128, 129), (32, 500)])
def test_auto_dispatch_follows_jax_shape_rule(dev, W, V):
    # outside (W <= 128 and V <= 128) or (W <= 64 and V <= 256), "auto"
    # runs the matched scan without touching the kernels, as JAX's
    # _use_pallas decides, and "pallas" raises JAX's message
    rng = np.random.default_rng(W + V)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((3, 2, V)))).to(
        dev)
    n0 = fused_decode.decode_launches
    res = tbs.ctc_beam_search(lp, beam_width=W, max_len=8)
    assert fused_decode.decode_launches == n0
    want = tbs.ctc_beam_search(lp, beam_width=W, max_len=8,
                               merge_impl="matched")
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="W <= 128 and V <= 128, or W <= 64 "
                                         "and V <= 256"):
        tbs.ctc_beam_search(lp, beam_width=W, merge_impl="pallas")
    # inside the rule "auto" takes the kernel
    tbs.ctc_beam_search(lp[:, :, :47].log_softmax(-1), beam_width=W // 2)
    assert fused_decode.decode_launches == n0 + 1


def _overlay_inputs(dev, Tc, B, W, L, seed, parent=None, max_len_extra=0,
                    offset_elems=0):
    """Synthetic chunk: random backpointers (parents in [0, W), or all
    `parent`), chars and append flags; final lengths up to L +
    max_len_extra; arbitrary base rows, placed `offset_elems` int32 into
    their allocation (unaligned when not a multiple of 4)."""
    rng = np.random.default_rng(seed)
    par = (rng.integers(0, W, (Tc, B, W)) if parent is None
           else np.full((Tc, B, W), parent))
    ys = (par | (rng.integers(0, 47, (Tc, B, W)) << 15)
          | (rng.integers(0, 2, (Tc, B, W)) << 30)).astype(np.int32)
    lens = rng.integers(0, L + max_len_extra + 1, (B, W)).astype(np.int32)
    n = B * W * L

    def base(hi):
        flat = torch.from_numpy(rng.integers(-1, hi, offset_elems + n,
                                             dtype=np.int32)).to(dev)
        return flat[offset_elems:].view(B, W, L)
    return (torch.from_numpy(ys).to(dev), torch.from_numpy(lens).to(dev),
            base(47), base(10 ** 6))


@pytest.mark.parametrize("Tc,B,W,L,parent,extra,offset", [
    (1, 3, 100, 256, None, 0, 0),      # Tc = 1
    (150, 2, 16, 64, None, 0, 0),      # a chunk of more than 128 frames
    (20, 4, 32, 8, None, 40, 0),       # emissions past L drop (overflow)
    (20, 3, 128, 32, 0, 5, 0),         # every row reads parent row 0
    (7, 2, 5, 13, None, 3, 0),         # L not a multiple of 4
    (7, 2, 5, 16, None, 3, 1),         # base buffers not 16-byte aligned
    (5, 2, 3, 0, None, 2, 0),          # L = 0: only start_parent
    (0, 2, 4, 8, None, 0, 0),          # an empty chunk: the base copied
])
def test_traceback_overlay_kernel_equals_plain(dev, Tc, B, W, L, parent,
                                               extra, offset):
    ys, lens, bt, bs = _overlay_inputs(dev, Tc, B, W, L, Tc * 1000 + W,
                                       parent, extra, offset)
    n0 = fused_decode.overlay_launches
    got = fused_decode.traceback_overlay(ys, lens, bt, bs, 1234)
    want = fused_decode.traceback_overlay_plain(ys, lens, bt, bs, 1234)
    torch.cuda.synchronize()
    assert fused_decode.overlay_launches == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for out in got[:2]:                # fresh buffers, never the base
        assert out.numel() == 0 or \
            out.data_ptr() not in (bt.data_ptr(), bs.data_ptr())


def test_traceback_overlay_kernel_empty_batch(dev):
    ys, lens, bt, bs = _overlay_inputs(dev, 4, 0, 8, 16, 1)
    n0 = fused_decode.overlay_launches
    tok, ts, start = fused_decode.traceback_overlay(ys, lens, bt, bs, 0)
    assert tok.shape == (0, 8, 16) and start.shape == (0, 8)
    assert fused_decode.overlay_launches == n0     # nothing to launch


@pytest.mark.parametrize("chunks", [[5, 1, 7, 2], [20, 20], [150, 10]])
def test_streaming_kernels_equal_plain_stream_on_card(dev, chunks):
    T, B, V, W, L = sum(chunks), 3, 29, 16, 32
    rng = np.random.default_rng(T)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((T, B, V)))).to(
        dev)
    counts = (fused_decode.decode_launches, fused_decode.overlay_launches,
              fused_decode.traceback_launches)
    results = {}
    for impl in ("auto", "matched"):
        st = tbs.streaming_init(B, W, max_len=L, device=dev)
        t = 0
        for c in chunks:
            st, snap = tbs.streaming_step(st, lp[t:t + c], merge_impl=impl)
            t += c
        results[impl] = snap
    n = len(chunks)
    assert (fused_decode.decode_launches, fused_decode.overlay_launches,
            fused_decode.traceback_launches) == (counts[0] + n,
                                                 counts[1] + n, counts[2])
    for f in results["auto"]._fields:
        assert torch.equal(getattr(results["auto"], f),
                           getattr(results["matched"], f)), f
    batch = tbs.ctc_beam_search(lp, beam_width=W, max_len=L)
    for f in batch._fields:
        assert torch.equal(getattr(results["auto"], f), getattr(batch, f)), f


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
