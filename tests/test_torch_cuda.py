"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main paths do not reach (ragged sizes, envelope
corners, short runs, the decode's LM variant up to V=255 and its stream,
the streaming overlay's overflow and shared
parents, the attention's shortest and longest T and head widths, the
stem's ragged tiles and widths, the LSTM recurrence's padded units,
off-tile batches and two-direction launches), the decoder's (also with
an LM at V=256), the conformer's and the LSTM models' dispatch on CUDA
tensors, `transcribe_audio` on the card against the CPU, and the
wrappers' refusals. Marked `cuda`;
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
from gasr_tpu_torch.ops.cuda import (flash_mhsa, fused_decode, lstm_scan,
                                     rnn_scan, stem, topk)
from gasr_tpu_torch.ops.linear import matmul

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
    assert lstm_scan.launches == n0 + T
    assert got.shape == want.shape == (T, B, H)
    # a few steps: float32 sum order, and the rare bf16 rounding flip of h
    assert float((got - want).abs().max()) < 1e-3


@pytest.mark.parametrize("B,H", [(16, 256), (5, 40)])
def test_lstm_scan_bidir_kernel_equals_two_single_calls(dev, B, H):
    xw_f, w_f, h0, c0 = _lstm_inputs(dev, 6, B, H, 1)
    xw_b, w_b, _, _ = _lstm_inputs(dev, 6, B, H, 2)
    n0 = lstm_scan.launches
    got = lstm_scan.lstm_scan_bidir(xw_f, xw_b, w_f, w_b, h0, c0)
    assert lstm_scan.launches == n0 + 6         # both directions per launch
    want = torch.cat([lstm_scan.lstm_scan(xw_f, w_f, h0, c0),
                      lstm_scan.lstm_scan(xw_b, w_b, h0, c0, reverse=True)],
                     dim=-1)
    assert torch.equal(got, want)              # the same blocks, bit for bit


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
            T = got.shape[0]
            assert lstm_scan.launches - n0 == (2 * T if n is None else n)
            assert float((got.cpu() - want).abs().max()) <= tol


# kernel against plain: 0.02 * max(1, max|plain|), the JAX package's own
# kernel-against-oracle bound (tests/test_flash_mhsa.py, tests/test_stem.py)
KERNEL_REL = 0.02


def _flash_inputs(dev, B, H, T, dh, seed, ragged):
    rng = np.random.default_rng(seed)
    D = H * dh

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dev)
    lens = rng.integers(1, T + 1, B) if ragged else np.full(B, T)
    return (t(B, H, T, dh), t(B, H, T, dh), t(B, H, T, dh),
            t(D, D, s=D ** -0.5), t(H, dh, s=0.1), t(H, dh, s=0.1),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


@pytest.mark.parametrize("B,H,T,dh,ragged", [
    (64, 8, 300, 64, True),        # conformer_l, ragged lengths
    (32, 4, 150, 36, True),        # conformer_s: dh padded to 48
    (2, 8, 1024, 64, True),        # the longest eligible T (query tile 32)
    (3, 8, 2, 64, False),          # the shortest
    (2, 3, 17, 10, True),          # D/2 = 15, T not a multiple of 16
    (2, 16, 77, 128, True),        # dh = 128, D = 2048
    (1, 2, 1024, 128, False),      # query tile 32 at D = 256
])
@pytest.mark.parametrize("out_f32", [False, True])
def test_flash_mhsa_kernel_close_to_plain(dev, B, H, T, dh, ragged, out_f32):
    ins = _flash_inputs(dev, B, H, T, dh, B * T + dh, ragged)
    n0 = flash_mhsa.launches
    got = flash_mhsa.flash_mhsa_rel(*ins, out_f32=out_f32)
    want = flash_mhsa.flash_mhsa_rel_plain(*ins, out_f32=out_f32)
    torch.cuda.synchronize()
    assert flash_mhsa.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    lens = ins[-1].cpu()
    for b in range(B):
        g, w = got[b, :, :lens[b]].float(), want[b, :, :lens[b]].float()
        assert float((g - w).abs().max()) <= KERNEL_REL * max(
            1.0, float(w.abs().max()))


def test_flash_mhsa_kernel_zero_length_averages_v(dev):
    ins = list(_flash_inputs(dev, 2, 2, 40, 16, 3, False))
    ins[-1] = torch.tensor([0, 40], dtype=torch.int32, device=dev)
    got = flash_mhsa.flash_mhsa_rel(*ins, out_f32=True)
    want = flash_mhsa.flash_mhsa_rel_plain(*ins, out_f32=True)
    assert float((got - want).abs().max()) <= KERNEL_REL


@pytest.mark.parametrize("B,T,F,d,dout,out", [
    (64, 1200, 80, 512, 512, torch.bfloat16),   # conformer_l
    (3, 1000, 80, 512, 512, torch.float32),     # T/4 = 250: a ragged tile
    (2, 16, 8, 128, 256, torch.float32),        # F/4 = 2: a ragged f group
    (2, 40, 12, 256, 1024, torch.bfloat16),     # dout = 1024
    (1, 24, 16, 1024, 128, torch.float32),      # d = 1024
])
def test_fused_stem_kernel_close_to_plain(dev, B, T, F, d, dout, out):
    rng = np.random.default_rng(T + d)

    def t(*shape, s):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dev)
    x = torch.from_numpy(rng.uniform(size=(B, T, F)).astype(np.float32)).to(
        dev)
    w = (t(3, 3, 1, d, s=0.2), t(d, s=0.1), t(3, 3, d, d, s=(9 * d) ** -0.5),
         t(d, s=0.1), t(F // 4 * d, dout, s=(F // 4 * d) ** -0.5 * 2),
         t(dout, s=0.1))
    n0 = stem.launches
    got = stem.fused_stem(x, *w, out_dtype=out)
    want = stem.fused_stem_plain(x, *w, out_dtype=out)
    torch.cuda.synchronize()
    assert stem.launches == n0 + 1
    assert got.dtype == out and got.shape == (B, T // 4, dout)
    assert float((got.float() - want.float()).abs().max()) <= KERNEL_REL * \
        max(1.0, float(want.float().abs().max()))


def test_kernel_wrappers_refuse(dev):
    ins = _flash_inputs(dev, 1, 2, 8, 8, 0, False)
    with pytest.raises(ValueError, match="flash_eligible"):
        flash_mhsa.flash_mhsa_rel(*_flash_inputs(dev, 1, 1, 1025, 8, 0,
                                                 False))
    with pytest.raises(ValueError, match="one device"):
        flash_mhsa.flash_mhsa_rel(*ins[:-1], ins[-1].cpu())
    with pytest.raises(NotImplementedError, match="forward only"):
        flash_mhsa.flash_mhsa_rel(ins[0].clone().requires_grad_(True),
                                  *ins[1:])
    w = [torch.zeros(s, device=dev) for s in
         ((3, 3, 1, 128), (128,), (3, 3, 128, 128), (128,), (256, 128),
          (128,))]
    with pytest.raises(ValueError, match="stem_eligible"):
        stem.fused_stem(torch.zeros(1, 18, 8, device=dev), *w)
    with pytest.raises(ValueError, match="one device"):
        stem.fused_stem(torch.zeros(1, 16, 8, device=dev), *w[:-1],
                        w[-1].cpu())
    with pytest.raises(NotImplementedError, match="forward only"):
        stem.fused_stem(torch.zeros(1, 16, 8, device=dev,
                                    requires_grad=True), *w)


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
