"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main paths do not reach (ragged sizes, envelope
corners, short runs, the decode's LM variant up to V=255 and its stream,
the streaming overlay's overflow and shared
parents, the attention's shortest and longest T and head widths, the
stem's ragged tiles and widths, the LSTM recurrence's padded units,
off-tile batches and two-direction launches; the vocab-sharded frame,
scan and exchange toy at W = 1, one-id windows, n = V, V = 256 and batches
off the persistent grid), the decoder's (also with an LM at V=256), the
conformer's and the LSTM models' dispatch on CUDA tensors, the TP decode
and stream on a mesh of one card, `transcribe_audio` on the card against
the CPU, and the refusals (a cooperative grid that cannot be resident,
the recurrences under autograd). Marked `cuda`;
every test skips without a card.

This file imports no JAX, so on a machine without JAX it runs as
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import dataclasses

from gasr_tpu_torch.config import PRESETS
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.ops.cuda import (_lib, exchange_probe, flash_mhsa,
                                     fused_decode, lstm_scan, rnn_scan, stem,
                                     topk)
from gasr_tpu_torch.ops.linear import matmul
from chip_smoke import signed_zero_frame, signed_zero_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize("kind", ["uniform", "signed_zeros", "few_values"])
def test_topk_kernel_equals_plain_on_tied_rows(dev, kind):
    """Rows where the threshold meets many equal scores: the order among
    them is the index order, and -0.0 ranks below +0.0."""
    rng = np.random.default_rng(len(kind))
    B, N, k = 4, 4700, 100
    if kind == "uniform":
        x = np.full((B, N), -np.log(47.0), np.float32)
    elif kind == "signed_zeros":
        x = np.where(rng.random((B, N)) < 0.5, 0.0, -0.0).astype(np.float32)
    else:
        x = rng.integers(0, 3, (B, N)).astype(np.float32)
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


def _tie_log_probs(kind, T, B, V, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return np.full((T, B, V), -np.log(V), np.float32)
    if kind == "all ties":                 # every candidate of a slot equal
        return np.zeros((T, B, V), np.float32)
    # +0.0 and -0.0 (lax.top_k ranks +0.0 above -0.0), a few -1.0
    z = np.where(rng.random((T, B, V)) < 0.5, 0.0, -0.0)
    return np.where(rng.random((T, B, V)) < 0.1, -1.0, z).astype(np.float32)


def _decode_equal_plain(lp, W, blank=0, lm_q=None):
    init = tbs._init_beam(lp.shape[1], W, lp.device)
    fin_k, ys_k = fused_decode.fused_prefix_decode(lp, init, blank, lm_q)
    fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp, init, blank,
                                                         lm_q)
    assert torch.equal(ys_k, ys_p)
    assert torch.equal(fused_decode.pack_state(fin_k),
                       fused_decode.pack_state(fin_p))
    return ys_k


@pytest.mark.parametrize("W,V,T,B,lm", [
    (1, 8, 12, 3, False),
    (128, 128, 5, 2, False),   # the envelope's corners
    (64, 256, 5, 2, False),
    (64, 255, 4, 2, True),     # the LM variant at JAX's ceiling
    (100, 47, 9, 1, False),    # one utterance
    (100, 47, 4, 300, False),  # past one wave (264 blocks on an H100)
])
@pytest.mark.parametrize("kind", ["uniform", "all ties", "signed zeros"])
def test_decode_kernel_equals_plain_on_tie_grids(dev, W, V, T, B, lm, kind):
    """The filtered top-W (csrc/topk.cuh) keeps lax.top_k's order where
    every candidate ties: score descending, index ascending, +0.0 above
    -0.0; frame 0 holds fewer live candidates than W."""
    lp = torch.from_numpy(_tie_log_probs(kind, T, B, V, W + V)).to(dev)
    _decode_equal_plain(lp, W, lm_q=_lm_table(dev, V, W) if lm else None)


def signed_zero_log_probs(T, B, V, seed):
    """Random log-probs with frame 0 from `chip_smoke.signed_zero_frame`:
    the tie of `signed_zero_state` sits in frame 0."""
    rng = np.random.default_rng(seed)
    lp = _log_softmax(rng.standard_normal((T, B, V)))
    lp[0] = signed_zero_frame(B, V, rng)
    return lp


@pytest.mark.parametrize("W,V,T,B,lm", [
    (100, 47, 6, 3, False),    # the flagship's W and V
    (16, 129, 5, 2, False),    # conformer_l's
    (64, 129, 4, 2, True),     # the LM variant
    (8, 12, 7, 2, False),
    (128, 128, 3, 2, False),   # the envelope's corners
    (64, 256, 3, 2, False),
])
def test_decode_kernel_equals_plain_on_signed_zero_ties(dev, W, V, T, B, lm):
    """From a beam whose live slots carry -0.0 (`signed_zero_state`), frame 0
    ties -0.0 extends with +0.0 candidates inside the kernel: bit-equal to
    the eager matched scan, which ranks +0.0 first as lax.top_k and, at
    k < n, lax.approx_max_k do; the -0.0 cell (slot 0, symbol 1) is no
    winner of frame 0 (with an LM no candidate scores -0.0: the table
    holds no -0.0, and -0.0 + +0.0 = +0.0)."""
    lp = torch.from_numpy(signed_zero_log_probs(T, B, V, W)).to(dev)
    init = signed_zero_state(B, W, V, dev)
    lm_q = _lm_table(dev, V, W) if lm else None
    fin_k, ys_k = fused_decode.fused_prefix_decode(lp, init, 0, lm_q)
    fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp, init, 0, lm_q)
    assert torch.equal(ys_k, ys_p)
    assert torch.equal(fused_decode.pack_state(fin_k),
                       fused_decode.pack_state(fin_p))
    parent, char, appended = tbs._unpack_ys(ys_k[0])
    assert not ((parent == 0) & (char == 1) & appended).any()


def test_approx_ctc_beam_search_takes_the_kernel(dev):
    """"auto" with topk_impl="approx" on CUDA tensors: one decode launch and
    one traceback launch, no standalone topk, equal to the eager matched
    scan with approx and to the exact decode (also with lm_bias and
    input_lengths); "pallas" refuses approx, as in JAX."""
    T, B, V, W = 12, 3, 29, 16
    rng = np.random.default_rng(5)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((T, B, V)))).to(
        dev)
    for kw in ({}, {"lm_bias": _lm_table(dev, V, 3)},
               {"input_lengths": torch.tensor([12, 7, 1], device=dev)}):
        n = (fused_decode.decode_launches, fused_decode.traceback_launches,
             topk.launches)
        got = tbs.ctc_beam_search(lp, W, max_len=16, topk_impl="approx", **kw)
        assert (fused_decode.decode_launches - n[0],
                fused_decode.traceback_launches - n[1],
                topk.launches - n[2]) == (1, 1, 0)
        for other in (dict(topk_impl="approx", merge_impl="matched"), {}):
            want = tbs.ctc_beam_search(lp, W, max_len=16, **other, **kw)
            for f in got._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="exact-top-k only"):
        tbs.ctc_beam_search(lp, W, merge_impl="pallas", topk_impl="approx")


def test_decode_kernel_back_to_back_on_one_stream(dev):
    """Calls of every instantiation (1, 2 and 4 keys a lane, with and
    without an LM) queued on one stream with no synchronisation between
    them, each equal to its plain version."""
    rng = np.random.default_rng(17)
    runs = []
    for W, V, T, B, lm in ((16, 129, 30, 64, False), (100, 47, 40, 256, False),
                           (64, 129, 20, 32, True), (100, 47, 40, 256, True),
                           (32, 29, 25, 8, False)):
        lp = torch.from_numpy(_log_softmax(
            rng.standard_normal((T, B, V)))).to(dev)
        lm_q = _lm_table(dev, V, W) if lm else None
        init = tbs._init_beam(B, W, dev)
        runs.append((lp, init, lm_q,
                     fused_decode.fused_prefix_decode(lp, init, lm_q=lm_q)))
    for lp, init, lm_q, (fin_k, ys_k) in runs:
        fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp, init,
                                                             lm_q=lm_q)
        assert torch.equal(ys_k, ys_p)
        assert torch.equal(fused_decode.pack_state(fin_k),
                           fused_decode.pack_state(fin_p))


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


def _traceback_inputs(dev, T, B, W, L, extra, seed):
    """Random backpointers and chars, nine appends in ten; lengths up to
    L + extra, 0 among them."""
    rng = np.random.default_rng(seed)
    ys = (rng.integers(0, W, (T, B, W)) | (rng.integers(0, 47, (T, B, W))
                                          << 15)
          | ((rng.random((T, B, W)) < 0.9).astype(np.int64) << 30)).astype(
        np.int32)
    lens = rng.integers(0, L + extra + 1, (B, W)).astype(np.int32)
    lens.flat[0] = 0
    return torch.from_numpy(ys).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("T,B,W,L,extra", [
    (200, 256, 100, 256, 0),    # reference_large's shape
    (300, 64, 16, 256, 0),      # conformer_l's
    (200, 256, 100, 256, 300),  # lengths past L: the head is kept
    (23, 2, 5, 12, 10),
    (9, 3, 1, 6, 3),            # W = 1
    (7, 2, 128, 9, 4),          # W = 128
    (5, 2, 4, 0, 2),            # L = 0: only start_parent
    (0, 2, 6, 8, 3),            # T = 0: every cell -1
    (11, 2, 200, 7, 3),         # W > 128: two blocks an utterance
])
def test_traceback_kernel_equals_plain_at_edge_shapes(dev, T, B, W, L, extra):
    ys, lens = _traceback_inputs(dev, T, B, W, L, extra, T + W + L)
    n0 = fused_decode.traceback_launches
    got = fused_decode.traceback(ys, lens, L)
    torch.cuda.synchronize()
    assert fused_decode.traceback_launches == n0 + 1
    for a, b in zip(got, fused_decode.traceback_plain(ys, lens, L)):
        assert torch.equal(a, b)


def test_traceback_kernel_writes_every_cell_without_a_fill(dev):
    # the kernel writes the -1 cells itself: one device kernel a call, no
    # memset before it; outputs that start as garbage come out right
    ys, lens = _traceback_inputs(dev, 40, 8, 16, 32, 8, 1)
    torch.empty(8 * 16 * 32 * 4, dtype=torch.int32, device=dev).fill_(7)
    fused_decode.traceback(ys, lens, 32)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = fused_decode.traceback(ys, lens, 32)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "traceback_kernel" in names[0], names
    for a, b in zip(got, fused_decode.traceback_plain(ys, lens, 32)):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("V,W", [(1025, 16), (300, 16), (200, 128)])
def test_ctc_beam_search_past_the_decode_kernel_takes_the_vocab_shards(
        dev, V, W):
    """Past the decode kernel's shape rule, "auto" runs the frame kernel
    over ceil(V / 128) shards of the card (T + 1 launches) and the
    traceback kernel, bit-equal to the matched scan; blank last."""
    T = 40
    rng = np.random.default_rng(V)
    lp = torch.from_numpy(_log_softmax(
        3 * rng.standard_normal((T, 4, V)))).to(dev)
    lens = torch.tensor([40, 23, 7, 1], device=dev)
    before = (fused_decode.tp_frame_launches, fused_decode.decode_launches,
              fused_decode.traceback_launches)
    a = tbs.ctc_beam_search(lp, beam_width=W, blank_id=V - 1,
                            input_lengths=lens)
    assert (fused_decode.tp_frame_launches - before[0],
            fused_decode.decode_launches - before[1],
            fused_decode.traceback_launches - before[2]) == (T + 1, 0, 1)
    b = tbs.ctc_beam_search(lp, beam_width=W, blank_id=V - 1,
                            input_lengths=lens, merge_impl="matched")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32))


def _lm_table(dev, V, seed):
    """A quantized standard-normal [V+1, V] table with -0.0 planted."""
    lm = np.random.default_rng(seed).standard_normal((V + 1, V)).astype(
        np.float32)
    lm[::3, ::4] = -0.0
    return tbs._quantize_lm(torch.from_numpy(lm), V, dev)


@pytest.mark.parametrize("W,V,T,B", [
    (100, 47, 20, 4),          # the flagship's W and V
    (64, 129, 10, 3),          # conformer_s's decode shape
    (64, 255, 6, 2),           # JAX's LM ceiling
    (128, 128, 5, 2),
    (1, 5, 9, 2),
])
@pytest.mark.parametrize("kind", ["random", "relu"])
def test_lm_decode_kernel_equals_plain(dev, W, V, T, B, kind):
    rng = np.random.default_rng(W * V + T + 1)
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    lp = (_log_softmax(x) if kind == "random"
          else np.maximum(np.round(x * 2) / 2, 0.0).astype(np.float32))
    lp = torch.from_numpy(lp).to(dev)
    lm_q = _lm_table(dev, V, W + V)
    init = tbs._init_beam(B, W, dev)
    n0 = fused_decode.decode_lm_launches
    fin_k, ys_k = fused_decode.fused_prefix_decode(lp, init, lm_q=lm_q)
    fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp, init, lm_q=lm_q)
    assert fused_decode.decode_lm_launches == n0 + 1
    assert torch.equal(ys_k, ys_p)
    for f in fused_decode.FIELDS:
        a, b = getattr(fin_k, f), getattr(fin_p, f)
        assert torch.equal(a.to(b.dtype), b), f
    _, ys_n = fused_decode.fused_prefix_decode(lp, init)
    assert T == 1 or not torch.equal(ys_k, ys_n)


def test_lm_stream_on_card_equals_plain_stream(dev):
    chunks, B, V, W, L = [5, 1, 7, 7], 3, 29, 16, 32
    rng = np.random.default_rng(9)
    lp = torch.from_numpy(_log_softmax(
        rng.standard_normal((sum(chunks), B, V)))).to(dev)
    lm = _lm_table(dev, V, 9)
    results = {}
    for impl in ("auto", "matched"):
        n0 = fused_decode.decode_lm_launches
        st = tbs.streaming_init(B, W, max_len=L, device=dev)
        t = 0
        for c in chunks:
            st, snap = tbs.streaming_step(st, lp[t:t + c], merge_impl=impl,
                                          lm_bias=lm)
            t += c
        assert fused_decode.decode_lm_launches - n0 == (
            len(chunks) if impl == "auto" else 0)
        results[impl] = snap
    batch = tbs.ctc_beam_search(lp, beam_width=W, max_len=L, lm_bias=lm)
    for f in batch._fields:
        assert torch.equal(getattr(results["auto"], f),
                           getattr(results["matched"], f)), f
        assert torch.equal(getattr(results["auto"], f), getattr(batch, f)), f


def test_lm_auto_at_v256_takes_the_matched_scan(dev):
    rng = np.random.default_rng(256)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((4, 2, 256)))).to(
        dev)
    lm = _lm_table(dev, 256, 1)
    n0 = fused_decode.decode_launches
    res = tbs.ctc_beam_search(lp, beam_width=8, max_len=8, lm_bias=lm)
    assert fused_decode.decode_launches == n0
    want = tbs.ctc_beam_search(lp, beam_width=8, max_len=8, lm_bias=lm,
                               merge_impl="matched")
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="lm_bias only for V <= 255"):
        tbs.ctc_beam_search(lp, beam_width=8, lm_bias=lm, merge_impl="pallas")
    with pytest.raises(ValueError, match="envelope"):
        fused_decode.fused_prefix_decode(lp, tbs._init_beam(2, 8, dev),
                                         lm_q=lm)


def test_transcribe_audio_on_card_matches_cpu(dev):
    from gasr_tpu_torch.config import Config
    from gasr_tpu_torch.infer import Pipeline
    rng = np.random.default_rng(5)
    t = np.arange(16000, dtype=np.float64) / 16000
    waves = [(np.sin(2 * np.pi * f * t[:n]) + rng.standard_normal(n) * 0.02
              ).astype(np.float32)
             for f, n in ((500, 16000), (1200, 9000), (2600, 12345))]
    for cmvn in (False, True):
        cfg = Config(input_size=13, linear_size=64, rnn_hidden_size=64,
                     vocab_size=4, beam_width=8, decode_max_len=32,
                     cmvn=cmvn, device="cpu")
        want = Pipeline(cfg, generator=torch.Generator().manual_seed(3)
                        ).transcribe_audio(waves)
        n0 = fused_decode.decode_launches
        got = Pipeline(dataclasses.replace(cfg, device="cuda"),
                       generator=torch.Generator().manual_seed(3)
                       ).transcribe_audio(waves)
        assert fused_decode.decode_launches == n0 + 1
        assert got == want


@pytest.mark.parametrize("T,B,H,reverse", [(4, 3, 100, False),
                                           (3, 70, 130, True),
                                           (2, 1, 1, False),
                                           # 4 n8 tiles a warp
                                           (3, 130, 1024, False),
                                           # chunks of 64 rows, 2 of them
                                           (3, 70, 2560, True)])
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


@pytest.mark.parametrize("T,B,H,reverse", [(5, 1, 2048, False),
                                           (4, 1, 512, True)])
def test_rnn_scan_kernel_batch_of_one(dev, T, B, H, reverse):
    rng = np.random.default_rng(H + T)
    xw = torch.from_numpy((rng.standard_normal((T, B, H)) * 0.5).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (H, H)) / H ** 0.5).astype(
        np.float32)).to(dev)
    h0 = torch.tanh(torch.from_numpy(rng.standard_normal((B, H)).astype(
        np.float32))).to(dev)
    n0 = rnn_scan.launches
    got = rnn_scan.rnn_scan(xw, w, h0, reverse=reverse)
    assert rnn_scan.launches == n0 + 1          # one persistent launch
    want = rnn_scan.rnn_scan_plain(xw, w, h0, reverse=reverse)
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3


def test_recurrence_kernels_back_to_back_on_one_stream(dev):
    # the second call on the stream starts from the first one's last h
    # (and c), with barrier words of its own: the two halves give what one
    # call over the whole sequence gives
    rng = np.random.default_rng(5)
    T, B, H = 12, 64, 256
    xw = torch.from_numpy((rng.standard_normal((T, B, H)) * 0.5).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (H, H)) / H ** 0.5).astype(
        np.float32)).to(dev)
    h0 = torch.zeros(B, H, device=dev)
    first = rnn_scan.rnn_scan(xw[:5], w, h0)
    second = rnn_scan.rnn_scan(xw[5:], w, first[-1])
    whole = rnn_scan.rnn_scan(xw, w, h0)
    assert torch.equal(torch.cat([first, second]), whole)
    xl, wl, hl, cl = _lstm_inputs(dev, T, 24, 128, 6)
    one = lstm_scan.lstm_scan(xl[:7], wl, hl, cl)
    # c after 7 steps, from the plain version on the same inputs
    c7 = cl.clone()
    wb = wl.to(torch.bfloat16).float()
    h = hl.clone()
    for t in range(7):
        pre = xl[t] + torch.matmul(h.to(torch.bfloat16).float(), wb)
        i, f, g, o = pre.split(128, dim=1)
        c7 = torch.sigmoid(f) * c7 + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c7)
    two = lstm_scan.lstm_scan(xl[7:], wl, one[-1], c7)
    want = lstm_scan.lstm_scan_plain(xl, wl, hl, cl)
    assert float((torch.cat([one, two]) - want).abs().max()) < 1e-3


@pytest.mark.parametrize("D", [1, 2])
def test_lstm_scan_past_the_resident_limit_launches_once(dev, D):
    # past the resident design's limit (H > 1008 on an H100) the streamed
    # design: one launch, close to the plain version (it raised before)
    B, T = 4, 5
    H = lstm_scan.max_hidden(2) + lstm_scan.UNITS
    assert lstm_scan.design(dev, B, H, D) == "streamed"
    xw_f, w_f, h0, c0 = _lstm_inputs(dev, T, B, H, H + D)
    xw_b, w_b, _, _ = _lstm_inputs(dev, T, B, H, H + D + 1)
    n0, s0 = lstm_scan.launches, lstm_scan.streamed_launches
    if D == 2:
        got = lstm_scan.lstm_scan_bidir(xw_f, xw_b, w_f, w_b, h0, c0)
        want = torch.cat([
            lstm_scan.lstm_scan_plain(xw_f, w_f, h0, c0),
            lstm_scan.lstm_scan_plain(xw_b, w_b, h0, c0, reverse=True)], -1)
    else:
        got = lstm_scan.lstm_scan(xw_f, w_f, h0, c0, reverse=True)
        want = lstm_scan.lstm_scan_plain(xw_f, w_f, h0, c0, reverse=True)
    torch.cuda.synchronize()
    assert (lstm_scan.launches - n0, lstm_scan.streamed_launches - s0) == (
        1, 1)
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3


@pytest.mark.parametrize("B,reverse", [(2, False), (20, True)])
def test_rnn_scan_past_the_resident_limit_launches_once(dev, B, reverse):
    # past the resident design's limit the streamed design: one launch,
    # close to the plain version
    H = rnn_scan.max_hidden(dev) + 128
    assert rnn_scan.design(dev, B, H) == "streamed"
    rng = np.random.default_rng(H + B)
    xw = torch.from_numpy((rng.standard_normal((4, B, H)) * 0.5).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.uniform(-1, 1, (H, H)) / H ** 0.5).astype(
        np.float32)).to(dev)
    h0 = torch.tanh(torch.from_numpy(rng.standard_normal((B, H)).astype(
        np.float32))).to(dev)
    n0, s0 = rnn_scan.launches, rnn_scan.streamed_launches
    got = rnn_scan.rnn_scan(xw, w, h0, reverse=reverse)
    torch.cuda.synchronize()
    assert (rnn_scan.launches - n0, rnn_scan.streamed_launches - s0) == (1,
                                                                         1)
    want = rnn_scan.rnn_scan_plain(xw, w, h0, reverse=reverse)
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3
    one = rnn_scan.rnn_scan(xw[:1], w, h0, reverse=reverse)
    assert float((one - rnn_scan.rnn_scan_plain(
        xw[:1], w, h0, reverse=reverse)).abs().max()) <= 1e-5


@pytest.mark.parametrize("B,H,T", [(8, 2816, 3), (256, 4480, 2),
                                   (24, 3000, 3)])
def test_rnn_forward_pallas_takes_the_kernel_at_every_jax_shape(dev, B, H, T):
    # rnn_forward(impl="pallas") takes the kernel wherever JAX's rule
    # admits (H % 128 == 0, B % 8 == 0), past the resident limit too: one
    # launch a direction; at H = 3000 (outside the rule) the float32 loop
    from gasr_tpu_torch.ops.rnn import rnn_forward, rnn_init
    params = rnn_init(torch.Generator().manual_seed(H), 16, H,
                      bidirectional=True)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (T, B, 16)).astype(np.float32))
    on_card = {k: [{n: v.to(dev) for n, v in c.items()} for c in layers]
               for k, layers in params.items()}
    n0, s0 = rnn_scan.launches, rnn_scan.streamed_launches
    with torch.no_grad():
        got = rnn_forward(on_card, x.to(dev), impl="pallas")
        torch.cuda.synchronize()
        want = rnn_forward(params, x, impl="pallas")   # the plain version
    n = 2 if H % 128 == 0 else 0
    assert (rnn_scan.launches - n0, rnn_scan.streamed_launches - s0) == (n,
                                                                         n)
    assert got.shape == want.shape == (T, B, 2 * H)
    assert float((got.cpu() - want).abs().max()) < 1e-3


@pytest.mark.parametrize("B,H,T", [(8, 1152, 3), (256, 2048, 2),
                                   (24, 1100, 3)])
def test_lstm_forward_pallas_takes_the_kernel_at_every_jax_shape(dev, B, H,
                                                                 T):
    # lstm_forward(impl="pallas") takes the kernel wherever JAX's rule
    # admits (H % 128 == 0, B % 8 == 0), past the resident limit too: one
    # launch a layer for both directions; at H = 1100 (outside the rule)
    # the float32 loop
    from gasr_tpu_torch.ops.lstm import lstm_forward, lstm_init
    params = lstm_init(torch.Generator().manual_seed(H), 16, H,
                       bidirectional=True)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (T, B, 16)).astype(np.float32))
    on_card = {k: [{n: v.to(dev) for n, v in c.items()} for c in layers]
               for k, layers in params.items()}
    n0, s0 = lstm_scan.launches, lstm_scan.streamed_launches
    with torch.no_grad():
        got = lstm_forward(on_card, x.to(dev), impl="pallas")
        torch.cuda.synchronize()
        want = lstm_forward(params, x, impl="pallas")  # the plain version
    n = 1 if H % 128 == 0 else 0
    assert (lstm_scan.launches - n0, lstm_scan.streamed_launches - s0) == (
        n, n)
    assert got.shape == want.shape == (T, B, 2 * H)
    assert float((got.cpu() - want).abs().max()) < 1e-3


def test_plans_shared_memory_equals_the_kernels(dev):
    # the wrappers size the streamed Elman and traceback blocks with
    # Python copies of the kernels' shared-memory arithmetic: the same
    # bytes as the C entries
    lib = _lib.load("rnn_scan")
    for B, H in ((8, 2816), (32, 5120), (256, 4480), (1024, 8192)):
        Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S = rnn_scan.stream_plan(
            B, H, 132)
        assert lib.rnn_stream_smem(MB, NU, WGK, S) == rnn_scan.stream_smem(
            MB, NU, WGK, S)
    lib = _lib.load("lstm_scan")
    for Hp in (16, 512, 1008):
        assert lib.lstm_scan_smem(Hp) == lstm_scan.resident_smem(Hp)
    for B, H, D in ((32, 1024, 2), (8, 1536, 2), (256, 2048, 2),
                    (1024, 8192, 1), (8, 8192, 2)):
        Hp, KS, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S = \
            lstm_scan.stream_plan(B, H, D, 132)
        assert lib.lstm_stream_smem(KS, MB, NU, WGK, S) == \
            lstm_scan.stream_smem(KS, MB, NU, WGK, S)
    lib = _lib.load("fused_decode")
    for T, W, L in ((200, 100, 256), (300, 16, 256), (2000, 128, 2048),
                    (200000, 4, 8), (0, 6, 8)):
        plan = fused_decode.traceback_plan(W)
        assert lib.traceback_smem(T, W, L, *plan) == \
            fused_decode.traceback_smem(T, W, L, *plan)


def test_recurrence_kernels_are_one_device_kernel_a_call(dev):
    # torch.profiler sees one device kernel for a call of each, and no
    # cuBLAS or cuDNN
    xw, w, h0, c0 = _lstm_inputs(dev, 4, 32, 512, 9)
    xr, wr = xw[..., :512].contiguous(), w[:, :512].contiguous()
    for fn in (lambda: rnn_scan.rnn_scan(xr, wr, h0),
               lambda: lstm_scan.lstm_scan(xw, w, h0, c0),
               lambda: lstm_scan.lstm_scan_bidir(xw, xw, w, w, h0, c0)):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and "scan_kernel" in names[0], names


def test_rnn_scan_kernel_rejects_float32_weights(dev):
    with pytest.raises(ValueError, match="bf16"):
        rnn_scan.rnn_scan(torch.zeros(1, 2, 4, device=dev),
                          torch.zeros(4, 4, device=dev),
                          torch.zeros(2, 4, device=dev),
                          weight_dtype=torch.float32)


def _lstm_inputs(dev, T, B, H, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(rng.standard_normal((T, B, 4 * H))),
            t(rng.uniform(-1, 1, (H, 4 * H)) / H ** 0.5),
            t(np.tanh(rng.standard_normal((B, H)))),
            t(rng.standard_normal((B, H))))


@pytest.mark.parametrize("T,B,H,reverse", [
    (4, 3, 100, False),        # H padded to 112, B off the 16-row tile
    (3, 24, 128, True),
    (5, 32, 512, False),       # deepspeech2's width
    (2, 1, 1, True),           # H = 1
    (1, 17, 64, False),        # one step
])
def test_lstm_scan_kernel_close_to_plain(dev, T, B, H, reverse):
    xw, w, h0, c0 = _lstm_inputs(dev, T, B, H, B * H + T)
    n0 = lstm_scan.launches
    got = lstm_scan.lstm_scan(xw, w, h0, c0, reverse=reverse)
    want = lstm_scan.lstm_scan_plain(xw, w, h0, c0, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_scan.launches == n0 + 1          # one persistent launch
    assert got.shape == want.shape == (T, B, H)
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3


@pytest.mark.parametrize("B,H", [(16, 256), (5, 40), (70, 512),
                                 (150, 96)])
def test_lstm_scan_bidir_kernel_equals_two_single_calls(dev, B, H):
    # B off the 32-row chunk (5, 70), and past a block's 128 rows (150: two
    # batch groups)
    xw_f, w_f, h0, c0 = _lstm_inputs(dev, 6, B, H, 1)
    xw_b, w_b, _, _ = _lstm_inputs(dev, 6, B, H, 2)
    n0 = lstm_scan.launches
    got = lstm_scan.lstm_scan_bidir(xw_f, xw_b, w_f, w_b, h0, c0)
    assert lstm_scan.launches == n0 + 1         # both directions, one launch
    want = torch.cat([lstm_scan.lstm_scan(xw_f, w_f, h0, c0),
                      lstm_scan.lstm_scan(xw_b, w_b, h0, c0, reverse=True)],
                     dim=-1)
    assert torch.equal(got, want)              # the same blocks, bit for bit


@pytest.mark.parametrize("D,B", [(2, 264), (2, 512), (1, 640)])
def test_lstm_scan_kernel_past_the_resident_batch_groups(dev, D, B):
    # more batch groups than the card holds at once at deepspeech2's width
    # (a block walks several, parking c between steps): still one launch
    T, H = 4, 512
    xw_f, w_f, h0, c0 = _lstm_inputs(dev, T, B, H, B + D)
    xw_b, w_b, _, _ = _lstm_inputs(dev, T, B, H, B + D + 1)
    n0 = lstm_scan.launches
    if D == 2:
        got = lstm_scan.lstm_scan_bidir(xw_f, xw_b, w_f, w_b, h0, c0)
        want = torch.cat([
            lstm_scan.lstm_scan_plain(xw_f, w_f, h0, c0),
            lstm_scan.lstm_scan_plain(xw_b, w_b, h0, c0, reverse=True)], -1)
    else:
        got = lstm_scan.lstm_scan(xw_f, w_f, h0, c0)
        want = lstm_scan.lstm_scan_plain(xw_f, w_f, h0, c0)
    assert lstm_scan.launches == n0 + 1
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3


def test_lstm_scan_kernel_padded_units_stay_zero(dev):
    # H = 100 against the same problem padded by hand to H = 112: the
    # padded units stay exactly 0 and change no real unit's output
    T, B, H, Hp = 7, 9, 100, 112
    xw, w, h0, c0 = _lstm_inputs(dev, T, B, H, 3)
    xw_p = torch.nn.functional.pad(xw.view(T, B, 4, H), (0, Hp - H)).view(
        T, B, 4 * Hp)
    w_p = torch.nn.functional.pad(w.view(H, 4, H),
                                  (0, Hp - H, 0, 0, 0, Hp - H)).view(Hp,
                                                                     4 * Hp)
    pad = torch.nn.functional.pad
    got_p = lstm_scan.lstm_scan(xw_p, w_p, pad(h0, (0, Hp - H)),
                                pad(c0, (0, Hp - H)))
    got = lstm_scan.lstm_scan(xw, w, h0, c0)
    assert torch.equal(got_p[..., H:], torch.zeros_like(got_p[..., H:]))
    assert torch.equal(got_p[..., :H], got)


def test_lstm_scan_kernel_refuses(dev):
    xw, w, h0, c0 = _lstm_inputs(dev, 2, 3, 16, 0)
    with pytest.raises(ValueError, match="do not fit"):
        lstm_scan.lstm_scan(xw, w, h0[:2], c0)
    with pytest.raises(ValueError, match="one device"):
        lstm_scan.lstm_scan(xw, w.cpu(), h0, c0)
    with pytest.raises(ValueError, match="both directions"):
        lstm_scan.lstm_scan_bidir(xw, xw[:1], w, w, h0, c0)


@pytest.mark.parametrize("preset", ["bilstm_2x256", "deepspeech2"])
def test_lstm_models_on_card_launch_and_match_cpu(dev, preset):
    # B = 8, H = 128: the kernel's shape rule admits them; card against
    # CPU with the same weights: float32 sum orders (TF32 off), and for
    # "pallas" the rare bf16 rounding flip of h
    cfg = dataclasses.replace(PRESETS[preset], batch_size=8, seg_len=15,
                              rnn_hidden_size=128, rnn_num_layers=2)
    params = model_init(dataclasses.replace(cfg, device="cpu"),
                        torch.Generator().manual_seed(0))
    on_card = model_init(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(8, 15, cfg.feat_size)).astype(np.float32))
    with torch.no_grad():
        for impl, tol, n in (("scan", 1e-5, 0), ("pallas", 1e-3, None)):
            n0 = lstm_scan.launches
            got = model_apply(cfg, on_card, x.to(dev), rnn_impl=impl)
            want = model_apply(cfg, params, x, rnn_impl=impl)
            # one launch a layer (both directions, every step)
            assert lstm_scan.launches - n0 == (cfg.rnn_num_layers
                                               if n is None else n)
            assert float((got.cpu() - want).abs().max()) <= tol


# kernel against plain: 0.02 * max(1, max|plain|), the JAX package's own
# kernel-against-oracle bound (tests/test_flash_mhsa.py, tests/test_stem.py)
KERNEL_REL = 0.02


def _flash_inputs(dev, B, H, T, dh, seed, ragged, views=False):
    """q, k, v, wr, u, vb, lengths; views=True gives q, k and v as
    mhsa_rel passes them: permuted bf16 views of one [T, B, 3D] qkv
    product; ragged="zero" also sets one length to 0."""
    rng = np.random.default_rng(seed)
    D = H * dh

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dev)
    lens = rng.integers(1, T + 1, B) if ragged else np.full(B, T)
    if ragged == "zero":
        lens[B // 2] = 0
    if views:
        qkv = t(T, B, 3 * D).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i * D:(i + 1) * D].reshape(T, B, H, dh)
                   .permute(1, 2, 0, 3) for i in range(3))
    else:
        q, k, v = t(B, H, T, dh), t(B, H, T, dh), t(B, H, T, dh)
    return (q, k, v, t(D, D, s=D ** -0.5), t(H, dh, s=0.1), t(H, dh, s=0.1),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


@pytest.mark.parametrize("B,H,T,dh,ragged,views", [
    (64, 8, 300, 64, True, False),     # conformer_l, ragged lengths
    (64, 8, 300, 64, True, True),      # as mhsa_rel passes q, k, v
    (64, 8, 300, 64, "zero", False),   # a ragged batch with a length of 0
    (32, 4, 150, 36, True, False),     # conformer_s: dh padded to 48
    (32, 4, 150, 36, True, True),      # its views: 8-byte copies
    (2, 8, 1024, 64, True, False),     # the longest eligible T
    (3, 8, 2, 64, False, False),       # the shortest
    (2, 3, 17, 10, True, False),       # D/2 = 15, T not a multiple of 16
    (2, 3, 17, 10, True, True),        # views: 4-byte copies
    (2, 2, 9, 5, "zero", True),        # odd dh: synchronous copies
    (2, 16, 77, 128, True, False),     # dh = 128, D = 2048
    (1, 2, 1024, 128, False, False),   # T = 1024 at dh = 128
    (1, 32, 1024, 128, True, False),   # T = 1024 at D = 4096
])
@pytest.mark.parametrize("out_f32", [False, True])
def test_flash_mhsa_kernel_close_to_plain(dev, B, H, T, dh, ragged, views,
                                          out_f32):
    ins = _flash_inputs(dev, B, H, T, dh, B * T + dh, ragged, views)
    n0 = flash_mhsa.launches
    got = flash_mhsa.flash_mhsa_rel(*ins, out_f32=out_f32)
    want = flash_mhsa.flash_mhsa_rel_plain(*ins, out_f32=out_f32)
    torch.cuda.synchronize()
    assert flash_mhsa.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    lens = ins[-1].cpu()
    for b in range(B):
        # valid query rows; a length of 0 averages v on every row
        n = int(lens[b]) or T
        g, w = got[b, :, :n].float(), want[b, :, :n].float()
        assert float((g - w).abs().max()) <= KERNEL_REL * max(
            1.0, float(w.abs().max()))


def test_flash_mhsa_kernel_zero_length_averages_v(dev):
    ins = list(_flash_inputs(dev, 2, 2, 40, 16, 3, False))
    ins[-1] = torch.tensor([0, 40], dtype=torch.int32, device=dev)
    got = flash_mhsa.flash_mhsa_rel(*ins, out_f32=True)
    want = flash_mhsa.flash_mhsa_rel_plain(*ins, out_f32=True)
    assert float((got - want).abs().max()) <= KERNEL_REL


@pytest.mark.parametrize("B,T,F,d,dout,out,x_view", [
    (64, 1200, 80, 512, 512, torch.bfloat16, False),   # conformer_l
    (3, 1000, 80, 512, 512, torch.float32, False),     # T/4 = 250: the last
                                                       # row tile of a b holds
                                                       # 8 of 128 rows
    (2, 16, 8, 128, 256, torch.float32, False),        # F/4 = 2
    (2, 40, 12, 256, 1024, torch.bfloat16, False),     # F/4 = 3, dout = 1024
    (1, 24, 16, 1024, 128, torch.float32, False),      # d = 1024
    (3, 44, 12, 512, 512, torch.float32, False),       # F/4 = 3 at d = 512,
                                                       # 33 rows a b
    (2, 8, 8, 128, 128, torch.bfloat16, False),        # T = F = 8
    (4, 400, 80, 512, 512, torch.bfloat16, True),      # x a strided view
    (0, 1200, 80, 512, 512, torch.bfloat16, False),    # B = 0
    (2, 400, 128, 512, 512, torch.bfloat16, False),    # F/4 in two windows
    (2, 200, 160, 512, 512, torch.float32, True),      # two windows of 20
    (2, 104, 512, 512, 512, torch.bfloat16, False),    # six windows
    (1, 64, 100, 1024, 128, torch.float32, False),     # windows of 13, 12
])
def test_fused_stem_kernel_close_to_plain(dev, B, T, F, d, dout, out, x_view):
    rng = np.random.default_rng(T + d)

    def t(*shape, s):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dev)
    x = torch.from_numpy(rng.uniform(size=(B, T, F)).astype(np.float32)).to(
        dev)
    if x_view:                   # read through its strides, not copied
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert not x.is_contiguous()
    w = (t(3, 3, 1, d, s=0.2), t(d, s=0.1), t(3, 3, d, d, s=(9 * d) ** -0.5),
         t(d, s=0.1), t(F // 4 * d, dout, s=(F // 4 * d) ** -0.5 * 2),
         t(dout, s=0.1))
    n0 = stem.launches
    got = stem.fused_stem(x, *w, out_dtype=out)
    want = stem.fused_stem_plain(x, *w, out_dtype=out)
    torch.cuda.synchronize()
    assert stem.launches == n0 + (B > 0)
    assert got.dtype == out and got.shape == (B, T // 4, dout)
    if B:
        assert float((got.float() - want.float()).abs().max()) <= \
            KERNEL_REL * max(1.0, float(want.float().abs().max()))


def test_kernel_wrappers_refuse(dev):
    ins = _flash_inputs(dev, 1, 2, 8, 8, 0, False)
    with pytest.raises(ValueError, match="flash_eligible"):
        flash_mhsa.flash_mhsa_rel(*_flash_inputs(dev, 1, 1, 1025, 8, 0,
                                                 False))
    with pytest.raises(ValueError, match="one device"):
        flash_mhsa.flash_mhsa_rel(*ins[:-1], ins[-1].cpu())
    # differentiable now: the kernel forward records the recompute backward
    assert flash_mhsa.flash_mhsa_rel(ins[0].clone().requires_grad_(True),
                                     *ins[1:]).requires_grad
    w = [torch.zeros(s, device=dev) for s in
         ((3, 3, 1, 128), (128,), (3, 3, 128, 128), (128,), (256, 128),
          (128,))]
    with pytest.raises(ValueError, match="stem_eligible"):
        stem.fused_stem(torch.zeros(1, 18, 8, device=dev), *w)
    with pytest.raises(ValueError, match="one device"):
        stem.fused_stem(torch.zeros(1, 16, 8, device=dev), *w[:-1],
                        w[-1].cpu())
    assert stem.fused_stem(torch.zeros(1, 16, 8, device=dev,
                                       requires_grad=True), *w).requires_grad
    # no frequency axis is refused for shared memory: the conv kernel's
    # block asks for the same bytes at every F (f2 windows of at most
    # WINDOW_MAX columns)
    wide = [torch.zeros(s, device=dev) for s in
            ((3, 3, 1, 512), (512,), (3, 3, 512, 512), (512,),
             (40 * 512, 128), (128,))]
    lib = _lib.load("stem")
    assert lib.stem_conv_smem(512) <= 232448
    assert lib.stem_window_max() == stem.WINDOW_MAX
    n0 = stem.launches
    out = stem.fused_stem(torch.zeros(1, 64, 160, device=dev), *wide)
    assert stem.launches == n0 + 1 and out.shape == (1, 16, 128)


@pytest.mark.parametrize("F", [128, 160])
def test_conformer_stem_pallas_at_wide_frequency_axes(dev, F):
    # conformer_apply(stem_impl="pallas") takes the stem kernel at any F
    # that stem_eligible admits (one call: its 2 kernel launches)
    cfg = dataclasses.replace(PRESETS["conformer_s"], linear_size=128,
                              num_blocks=1, input_size=F, batch_size=2,
                              seg_len=32, mesh_shape={})
    params = model_init(dataclasses.replace(cfg, device="cpu"),
                        torch.Generator().manual_seed(F))
    on_card = model_init(cfg, torch.Generator().manual_seed(F))
    x = torch.from_numpy(np.random.default_rng(F).uniform(
        size=(2, 32, F)).astype(np.float32))
    with torch.no_grad():
        s0 = stem.launches
        got = model_apply(cfg, on_card, x.to(dev), compute_dtype="bfloat16",
                          stem_impl="pallas")
        assert stem.launches == s0 + 1
        want = model_apply(cfg, params, x, compute_dtype="bfloat16",
                           stem_impl="pallas", attn_impl="pallas")
    assert got.shape == want.shape == (8, 2, cfg.output_size)
    assert float((got.cpu() - want).abs().max()) <= KERNEL_REL * \
        max(1.0, float(want.abs().max()))


def test_bf16_matmul_on_card_close_to_cpu(dev):
    # tensor cores (float32 output) against the float32 emulation on the
    # CPU: only the float32 summation order differs
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((3, 70, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 40)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3, 96, 40)).astype(np.float32))
    for bb in (b, c):
        got = matmul(a.to(dev), bb.to(dev), torch.bfloat16).cpu()
        want = matmul(a, bb, torch.bfloat16)
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 2.0 ** -8 * float(
            want.abs().max())


def test_conformer_forward_launches_and_matches_cpu(dev):
    cfg = dataclasses.replace(PRESETS["conformer_s"], linear_size=128,
                              num_blocks=2, input_size=8, batch_size=2,
                              seg_len=32, mesh_shape={})
    params = model_init(dataclasses.replace(cfg, device="cpu"),
                        torch.Generator().manual_seed(0))
    on_card = model_init(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(2, 32, 8)).astype(np.float32))
    with torch.no_grad():
        for stem_impl, n_stem in (("auto", 0), ("pallas", 1)):
            f0, s0 = flash_mhsa.launches, stem.launches
            got = model_apply(cfg, on_card, x.to(dev),
                              compute_dtype="bfloat16", stem_impl=stem_impl)
            assert (flash_mhsa.launches - f0, stem.launches - s0) == (2,
                                                                      n_stem)
            want = model_apply(cfg, params, x, compute_dtype="bfloat16",
                               stem_impl=stem_impl, attn_impl="pallas")
            assert got.shape == want.shape == (8, 2, cfg.output_size)
            assert float((got.cpu() - want).abs().max()) <= KERNEL_REL * \
                max(1.0, float(want.abs().max()))
        f0 = flash_mhsa.launches
        model_apply(cfg, on_card, x.to(dev))        # float32: never the kernel
        assert flash_mhsa.launches == f0


@pytest.mark.parametrize("which", ["rnn_scan", "lstm_scan", "lstm_scan_bidir"])
def test_recurrence_kernels_raise_under_autograd(dev, which):
    # JAX's jax.grad through rnn_scan_pallas_raw / lstm_scan_pallas_raw
    # fails; the kernels' wrappers raise rather than leave the graph
    xw, w, h0, c0 = _lstm_inputs(dev, 2, 8, 16, 0)
    w = w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        if which == "rnn_scan":
            rnn_scan.rnn_scan(xw[..., :16], w[:, :16], h0)
        elif which == "lstm_scan":
            lstm_scan.lstm_scan(xw, w, h0, c0)
        else:
            lstm_scan.lstm_scan_bidir(xw, xw, w, w, h0, c0)
    with torch.no_grad():                      # no graph: the kernel runs
        n0 = lstm_scan.launches
        lstm_scan.lstm_scan(xw, w, h0, c0)
        assert lstm_scan.launches == n0 + 1


def _tp_state(dev, B, V, W, frames, blank, seed):
    """A mid-decode packed state and the next frame's log-probs."""
    rng = np.random.default_rng(seed)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal(
        (frames + 1, B, V)))).to(dev)
    beam, _ = fused_decode.fused_prefix_decode_plain(
        lp[:frames], tbs._init_beam(B, W, dev), blank)
    return fused_decode.pack_state(beam), lp[frames]


@pytest.mark.parametrize("B,V,W,n,blank", [
    (3, 47, 1, 4, 0),          # W = 1
    (4, 13, 9, 13, 5),         # n = V: one-id windows
    (2, 256, 64, 2, 255),      # V = 256, windows of 128, blank last
    (5, 300, 128, 3, 0),       # V > 256 (the frame kernel has no V bound)
    (1, 40, 16, 8, 17),        # most windows without the blank
])
def test_tp_frame_kernel_equals_plain(dev, B, V, W, n, blank):
    st, f = _tp_state(dev, B, V, W, 4, blank, B * V + W)
    last = st[fused_decode.FIELDS.index("last")].long().clamp(0, V - 1)
    f_last, f_blank = torch.gather(f, 1, last), f[:, blank].contiguous()
    for lo, hi in fused_decode.shard_bounds(V, n):
        n0 = fused_decode.tp_frame_launches
        got = fused_decode.tp_frame(f[:, lo:hi], f_last, f_blank, st, lo, hi,
                                    V, blank)
        want = fused_decode.tp_frame_plain(f[:, lo:hi], f_last, f_blank, st,
                                           lo, hi, V, blank)
        assert fused_decode.tp_frame_launches == n0 + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (lo, hi)


def _resident(lib_name, capacity_fn, *args):
    """How many blocks of a cooperative kernel the card holds at once."""
    import ctypes
    cap = ctypes.c_int(0)
    lib = _lib.load(lib_name)
    _lib.check(getattr(lib, capacity_fn)(*args, ctypes.byref(cap)),
               capacity_fn)
    return cap.value


# B=None: one utterance more than the push design's persistent grid holds
# a shard, so some blocks walk two (the cluster design gives every
# utterance a cluster of its own)
@pytest.mark.parametrize("design", ["cluster", "push"])
@pytest.mark.parametrize("T,B,V,W,n", [
    (12, 3, 47, 1, 4),         # W = 1
    (9, 4, 13, 9, 13),         # n = V
    (6, 3, 256, 64, 2),        # V = 256
    (6, 2, 256, 64, 8),
    (6, None, 29, 6, 3),       # B not a multiple of the grid
    (3, None, 40, 100, 1),     # n = 1: no exchange
    (4, 3, 40, 8, 20),         # n past the cluster limit (16)
])
def test_tp_scan_kernel_equals_plain_and_single_card(dev, T, B, V, W, n,
                                                      design):
    limit = fused_decode.tp_cluster_limit(dev, W, V)
    if design == "cluster" and n > limit:
        with pytest.raises(ValueError, match="does not admit"):
            fused_decode.tp_scan(torch.zeros(T, 1, V, device=dev),
                                 fused_decode.pack_state(
                                     tbs._init_beam(1, W, dev)),
                                 [dev] * n, 0, design=design)
        return
    if B is None:
        B = _resident("decode_tp", "tp_scan_push_capacity", W, V, n) // n + 1
    rng = np.random.default_rng(T * B + V)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((T, B, V)))).to(
        dev)
    init = fused_decode.pack_state(tbs._init_beam(B, W, dev))
    n0 = fused_decode.tp_scan_launches
    fins, ys = fused_decode.tp_scan(lp, init, [dev] * n, 0, design=design)
    assert fused_decode.tp_scan_launches == n0 + 1
    fp, yp = fused_decode.tp_scan_plain(lp, init, n, 0)
    assert torch.equal(ys, yp) and torch.equal(fins, fp)
    beam, ys1 = fused_decode.fused_prefix_decode(
        lp, tbs._init_beam(B, W, dev))
    assert torch.equal(ys, ys1)
    for s in range(n):                         # equal on every shard
        assert torch.equal(fins[s], fused_decode.pack_state(beam))


def test_tp_scan_cluster_limit_and_design(dev):
    # the card admits clusters of the portable 8 at the flagship shape;
    # "auto" takes the cluster design up to TP_CLUSTER_PICK shards on one
    # card, push past it and across cards
    limit = fused_decode.tp_cluster_limit(dev, 100, 47)
    assert 8 <= limit <= 16
    assert fused_decode.pick_design(2, 1, 100, 47, limit) == "cluster"
    assert fused_decode.pick_design(4, 1, 100, 47, limit) == "push"
    assert fused_decode.pick_design(4, 2, 100, 47, limit) == "push"


# Bt=None: one row more than the push grid holds a shard
@pytest.mark.parametrize("design", ["cluster", "push"])
@pytest.mark.parametrize("n,Bt", [(2, 5), (4, 9), (8, None), (16, 3)])
def test_toy_exchange_kernel_equals_oracle(dev, n, Bt, design):
    if design == "cluster" and n > exchange_probe.toy_cluster_limit(dev):
        pytest.skip(f"the card holds no toy cluster of {n}")
    if Bt is None:
        Bt = _resident("exchange_probe", "toy_push_capacity", n) // n + 1
    rng = np.random.default_rng(n * Bt)
    keys = np.sort(rng.integers(-50, 50, (n, 7, Bt, 128)),
                   axis=-1)[..., ::-1].astype(np.int32).copy()
    n0 = exchange_probe.toy_exchange_launches
    got = exchange_probe.toy_exchange_scan(torch.from_numpy(keys).to(dev),
                                           n, design=design).cpu().numpy()
    assert exchange_probe.toy_exchange_launches == n0 + 1
    want = exchange_probe.toy_exchange_oracle(keys)
    for s in range(n):
        np.testing.assert_array_equal(got[s], want)


# the launches themselves refuse a grid past their design's limit (the
# wrappers size it to fit): the push design's cooperative grid that cannot
# be resident at once, the cluster design's cluster past the card's limit;
# an error code, nothing runs
_NOT_RESIDENT = r"""
import ctypes, sys, torch
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.ops.cuda import _lib, exchange_probe, fused_decode as fd
dev = torch.device("cuda")
tbl = lambda ts: torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64,
                              device=dev)
cap = ctypes.c_int(0)
lib = _lib.load("decode_tp")
_lib.check(lib.tp_scan_push_capacity(8, 16, 4, ctypes.byref(cap)),
           "capacity")
G = cap.value                                  # 4 shards x G blocks
lp = torch.zeros(3, 2, 16, device=dev).log_softmax(-1)
init = fd.pack_state(tbs._init_beam(2, 8, dev))
box = [torch.zeros(2, G, 4, 16, dtype=torch.int64, device=dev)
       for _ in range(4)]
shards = torch.arange(4, dtype=torch.int32, device=dev)
ys = torch.empty(3, 2, 8, dtype=torch.int32, device=dev)
fin = torch.empty(4, 9, 2, 8, dtype=torch.int32, device=dev)
err = lib.tp_scan_push_launch(lp.data_ptr(), init.data_ptr(), 3, 2, 8, 16, 0,
                              4, shards.data_ptr(), 4, G,
                              tbl(box).data_ptr(), ys.data_ptr(),
                              fin.data_ptr(), _lib.stream(dev))
torch.cuda.synchronize()
print("tp_scan push: launch error", err)
if err == 0:
    sys.exit("the oversized tp_scan push launch ran")
# a cluster past the card's limit (17 past the non-portable 16)
n = fd.tp_cluster_limit(dev, 8, 64) + 1
lp = torch.zeros(3, 2, 64, device=dev).log_softmax(-1)
fin = torch.empty(n, 9, 2, 8, dtype=torch.int32, device=dev)
err = lib.tp_scan_cluster_launch(lp.data_ptr(), init.data_ptr(), 3, 2, 8, 64,
                                 0, n, ys.data_ptr(), fin.data_ptr(),
                                 _lib.stream(dev))
torch.cuda.synchronize()
print("tp_scan cluster: launch error", err)
if err == 0:
    sys.exit("the tp_scan cluster past the card's limit ran")
lib = _lib.load("exchange_probe")
_lib.check(lib.toy_push_capacity(2, ctypes.byref(cap)), "capacity")
G = cap.value                                  # 2 shards x G blocks
keys = torch.zeros(2, 1, G, 128, dtype=torch.int32, device=dev)
box = [torch.zeros(2, G, 2, 256, dtype=torch.int64, device=dev)
       for _ in range(2)]
shards = torch.arange(2, dtype=torch.int32, device=dev)
out = torch.empty_like(keys)
err = lib.toy_push_launch(keys.data_ptr(), 1, G, 2, shards.data_ptr(), 2, G,
                          tbl(box).data_ptr(), out.data_ptr(),
                          _lib.stream(dev))
torch.cuda.synchronize()
print("toy_exchange push: launch error", err)
if err == 0:
    sys.exit("the oversized toy_exchange push launch ran")
n = exchange_probe.toy_cluster_limit(dev) + 1
keys = torch.zeros(n, 1, 2, 128, dtype=torch.int32, device=dev)
out = torch.empty_like(keys)
err = lib.toy_cluster_launch(keys.data_ptr(), 1, 2, n, out.data_ptr(),
                             _lib.stream(dev))
torch.cuda.synchronize()
print("toy_exchange cluster: launch error", err)
sys.exit(0 if err != 0 else "the toy cluster past the card's limit ran")
"""


def test_tp_grid_that_cannot_be_resident_raises_not_hangs(dev):
    # in a subprocess under a timeout: a grid of blocks that wait on each
    # other must be refused, never started (a started one could spin
    # forever on a peer that never becomes resident)
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run([sys.executable, "-c", _NOT_RESIDENT], cwd=root,
                       capture_output=True, text=True, timeout=180,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("launch error") == 4


@pytest.mark.parametrize("impl", ["auto", "fused", "fused_frame", "xla"])
def test_tp_decode_and_stream_on_one_card_equal_single_card(dev, impl):
    from gasr_tpu_torch.parallel import decode_tp, make_mesh
    T, B, V, W, L = 12, 3, 29, 16, 32
    rng = np.random.default_rng(29)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((T, B, V)))).to(
        dev)
    mesh = make_mesh({"data": 2, "model": 3}, devices=[dev] * 6)
    single = tbs.ctc_beam_search(lp, beam_width=W, max_len=L)
    counts = (fused_decode.tp_frame_launches, fused_decode.tp_scan_launches)
    got = decode_tp.ctc_beam_search_tp(lp, beam_width=W, mesh=mesh,
                                       max_len=L, tp_impl=impl)
    # one launch a frame on the one card, and the closing merge
    frames = {"auto": T + 1, "fused_frame": T + 1}.get(impl, 0)
    assert (fused_decode.tp_frame_launches - counts[0],
            fused_decode.tp_scan_launches - counts[1]) == (
        frames, int(impl == "fused"))
    for f in single._fields:
        a, b = getattr(got, f), getattr(single, f)
        if f == "scores":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    st = tbs.streaming_init(B, W, max_len=L, device=dev)
    n0 = fused_decode.overlay_launches
    for lo, hi in ((0, 5), (5, 6), (6, 12)):
        st, snap = decode_tp.streaming_step_tp(st, lp[lo:hi], mesh=mesh,
                                               tp_impl=impl)
    assert fused_decode.overlay_launches - n0 == (0 if impl == "xla" else 3)
    for f in single._fields:
        assert torch.equal(getattr(snap, f), getattr(got, f)), f


def test_tp_scan_and_decode_with_shards_on_several_cards(dev):
    # the push design: the inboxes of shards on another card are reached
    # through peer pointers, one cooperative launch per card; the frame
    # kernel writes its lists into every card's buffer
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from gasr_tpu_torch.parallel import decode_tp, make_mesh
    T, B, V, W = 14, 5, 29, 12
    rng = np.random.default_rng(7)
    lp = torch.from_numpy(_log_softmax(rng.standard_normal((T, B, V)))).to(
        dev)
    init = tbs._init_beam(B, W, dev)
    beam, ys1 = fused_decode.fused_prefix_decode(lp, init)
    single = tbs.ctc_beam_search(lp, beam_width=W, max_len=16)
    cards = [torch.device("cuda", i) for i in range(2)]
    for devices in (cards, [cards[0], cards[1], cards[0], cards[1]]):
        n0 = fused_decode.tp_scan_launches
        fins, ys = fused_decode.tp_scan(lp, fused_decode.pack_state(init),
                                        devices)
        assert fused_decode.tp_scan_launches == n0 + 2   # one per card
        assert torch.equal(ys, ys1)
        for s in range(len(devices)):
            assert torch.equal(fins[s], fused_decode.pack_state(beam))
        mesh = make_mesh({"model": len(devices)}, devices=devices)
        for impl in ("fused", "fused_frame"):
            got = decode_tp.ctc_beam_search_tp(lp, beam_width=W, mesh=mesh,
                                               max_len=16, tp_impl=impl)
            for f in single._fields:
                assert torch.equal(getattr(got, f), getattr(single, f)), f
        keys = np.sort(rng.integers(-50, 50, (len(devices), 5, 7, 128)),
                       axis=-1)[..., ::-1].astype(np.int32).copy()
        n0 = exchange_probe.toy_exchange_launches
        toy = exchange_probe.toy_exchange_scan(
            torch.from_numpy(keys).to(dev), len(devices), devices=devices)
        assert exchange_probe.toy_exchange_launches == n0 + 2
        want = exchange_probe.toy_exchange_oracle(keys)
        for s in range(len(devices)):
            np.testing.assert_array_equal(toy[s].cpu().numpy(), want)


# ------------------------------------------------------------- training

def test_flash_and_stem_grads_through_the_kernels(dev):
    # the kernel forwards under autograd; the grads are the recompute
    # backwards' (the VJPs of the plain versions), bit for bit
    ins = _flash_inputs(dev, 4, 2, 40, 16, 3, True)
    prims = [t.clone().requires_grad_() for t in ins[:-1]]
    g = torch.randn((4, 2, 40, 16), device=dev)
    for out_f32 in (False, True):
        n0 = flash_mhsa.launches
        got = torch.autograd.grad(flash_mhsa.flash_mhsa_rel(
            *prims, ins[-1], out_f32=out_f32), prims, g)
        assert flash_mhsa.launches == n0 + 1
        want = flash_mhsa.flash_mhsa_rel_vjp(*prims, ins[-1], g,
                                             out_f32=out_f32)
        for a, b, p in zip(got, want, prims):
            assert a.dtype == p.dtype and torch.equal(a, b)
    rng = np.random.default_rng(5)
    w = [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
         .to(dev).requires_grad_() for s, sc in (
             ((3, 3, 1, 128), 0.2), ((128,), 0.1), ((3, 3, 128, 128), 0.05),
             ((128,), 0.1), ((4 * 128, 128), 0.05), ((128,), 0.1))]
    x = torch.rand((2, 16, 16), device=dev)
    gs = torch.randn((2, 4, 128), device=dev).to(torch.bfloat16)
    torch.backends.cudnn.deterministic = True
    try:
        n0 = stem.launches
        got = torch.autograd.grad(stem.fused_stem(x, *w), w, gs)
        assert stem.launches == n0 + 1
        want = stem.fused_stem_vjp(x, *w, gs, needs=(False,) + (True,) * 6)
        for a, b in zip(got, want[1:]):
            assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("batched", [False, True])
def test_tensor_core_matmul_backward(dev, batched):
    # torch.mm / bmm(out_dtype=float32) have no derivative in torch: the
    # port's Function gives JAX's transpose (float32 products of the
    # float32 cotangent, rounded to bf16), held to float64 products
    a = torch.randn((3, 40, 64), device=dev).to(torch.bfloat16)
    b = (torch.randn((3, 64, 24) if batched else (64, 24), device=dev)
         * 0.1).to(torch.bfloat16)
    a.requires_grad_()
    b.requires_grad_()
    y = matmul(a, b, torch.bfloat16)
    assert y.dtype == torch.float32
    gy = torch.randn(y.shape, device=dev)
    ga, gb = torch.autograd.grad(y, (a, b), gy)
    ra = torch.matmul(gy.double(), b.detach().double().transpose(-1, -2))
    rb = torch.matmul(a.detach().double().transpose(-1, -2), gy.double())
    if not batched:
        rb = rb.sum(0)
    for got, ref in ((ga, ra), (gb, rb)):
        assert got.dtype == torch.bfloat16
        assert float((got.double() - ref).abs().max()) <= \
            2.0 ** -8 * float(ref.abs().max())


def test_train_step_on_the_card_matches_the_cpu(dev):
    # a float32 deepspeech step (TF32 off) on the card and on the CPU from
    # the same params and batch: only summation orders differ
    from gasr_tpu_torch.config import Config
    from gasr_tpu_torch.runtime.checkpoint import flatten_params
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      synthetic_batch)
    cfg = Config(batch_size=4, input_size=6, n_context=0, linear_size=32,
                 rnn_hidden_size=32, vocab_size=10, seg_len=24, device="cpu")
    res = {}
    for where in ("cpu", "cuda"):
        c = dataclasses.replace(cfg, device=where)
        params = model_init(c, torch.Generator().manual_seed(0))
        opt = make_optimizer()
        state = opt.init(params)
        batch = synthetic_batch(c, torch.Generator().manual_seed(1),
                                max_label_len=6)
        params, _, m = make_train_step(c, opt)(params, state, batch)
        res[where] = (flatten_params(params), float(m["loss"]),
                      float(m["grad_norm"]))
    (pc, lc, nc), (pg, lg, ng) = res["cpu"], res["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(ng, nc, rtol=1e-5)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, atol=1e-6)


def test_conformer_train_step_takes_the_kernels(dev):
    # a two-block bf16 conformer step on the card: the flash kernel's
    # forward in each block, the stem kernels' with stem_impl="pallas"
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      synthetic_batch)
    cfg = dataclasses.replace(PRESETS["conformer_s"], linear_size=128,
                              num_blocks=2, batch_size=2, seg_len=64,
                              input_size=16, vocab_size=12)
    params = model_init(cfg, torch.Generator().manual_seed(0))
    opt = make_optimizer()
    state = opt.init(params)
    step = make_train_step(cfg, opt, compute_dtype="bfloat16",
                           stem_impl="pallas")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1),
                            max_label_len=4)
    f0, s0 = flash_mhsa.launches, stem.launches
    losses = [float(step(params, state, batch)[2]["loss"])
              for _ in range(4)]
    assert flash_mhsa.launches == f0 + 8 and stem.launches == s0 + 4
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------- several cards

def test_sharded_train_step_with_ranks_on_several_cards(dev):
    # {"data": 2, "model": 2} over NCCL, one rank a card, against the
    # single-card step from the same params and batch (the CPU tests'
    # tolerances, tests/test_torch_parallel.py)
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four or more CUDA cards")
    from gasr_tpu_torch.config import Config
    from gasr_tpu_torch.parallel.distributed import spawn
    from gasr_tpu_torch.runtime._tree import tree_map
    from gasr_tpu_torch.runtime.checkpoint import flatten_params
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      sharded_train_run, synthetic_batch)
    cfg = Config(batch_size=8, input_size=6, n_context=1, linear_size=64,
                 rnn_hidden_size=64, vocab_size=9, seg_len=20, device="cpu")
    params = model_init(cfg)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1),
                            max_label_len=4)
    run = spawn(sharded_train_run, 4, "cuda", cfg, {"data": 2, "model": 2},
                batch, params)[0]
    p1 = tree_map(lambda t: t.to(dev), params)
    opt = make_optimizer()
    _, _, m = make_train_step(dataclasses.replace(cfg, device="cuda"), opt)(
        p1, opt.init(p1), {k: v.to(dev) for k, v in batch.items()})
    np.testing.assert_allclose(run["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(run["grad_norm"], float(m["grad_norm"]),
                               rtol=1e-5)
    want = flatten_params(p1)
    for k, v in flatten_params(run["params"]).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_dryrun_and_dp_scaling_on_several_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from gasr_tpu_torch.graft_entry import dryrun_multichip
    from gasr_tpu_torch.parallel.scaling import measure_dp_scaling
    dryrun_multichip(torch.cuda.device_count())
    cfg = dataclasses.replace(PRESETS["reference_large"], batch_size=16,
                              rnn_hidden_size=256, linear_size=256)
    rows = measure_dp_scaling(cfg, [1, 2], iters=2, decode=True)
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["launches"] == [{"fused_prefix_decode": 2,
                                  "traceback": 2}] * r["devices"]
