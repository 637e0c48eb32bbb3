"""PyTorch port's streaming path against the JAX package and against the
port's own batch decode: `streaming_step`, the traceback with the base
overlay (the plain version of the `traceback_overlay` kernel), the
chunked RNN and DeepSpeech forwards, and `Pipeline.transcribe_streaming`.

Inputs are made with numpy from a seed and handed to both packages.
Tokens, lengths and timesteps must be equal; scores agree to 1e-5 (torch
against XLA exp/log1p on the CPU, 3.8e-6 at most measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.infer import Pipeline as JPipeline
from gasr_tpu.models import model_init as j_init
from gasr_tpu.models.deepspeech import (
    deepspeech_apply_streaming as j_ds_streaming)
from gasr_tpu.ops.pallas.fused_decode import traceback_overlay_pallas
from gasr_tpu.ops.rnn import rnn_forward as j_rnn_forward, rnn_init

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.models.deepspeech import (deepspeech_apply,
                                              deepspeech_apply_streaming)
from gasr_tpu_torch.ops.cuda import fused_decode
from gasr_tpu_torch.ops.rnn import rnn_forward, rnn_forward_streaming
from gasr_tpu_torch.runtime.checkpoint import params_from_jax

SCORE_TOL = 1e-5


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _lp(seed, T, B, V, blank_shift=0.0):
    x = np.random.default_rng(seed).standard_normal((T, B, V))
    x[:, :, 0] += blank_shift
    return _log_softmax(x.astype(np.float32))


def _assert_same(got, want, fields=("tokens", "lengths", "timesteps",
                                    "overflow"), log_domain=True):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(np.asarray(got.scores),
                               np.asarray(want.scores), rtol=SCORE_TOL,
                               atol=SCORE_TOL if log_domain else 0.0)


def _port_stream(x, W, L, chunks, **kw):
    B = x.shape[1]
    state = tbs.streaming_init(B, W, max_len=L, device="cpu",
                               log_domain=not kw.get("prob_domain", False))
    t, snaps = 0, []
    for i, c in enumerate(chunks):
        state, snap = tbs.streaming_step(
            state, torch.from_numpy(x[t:t + c]),
            is_final=(i == len(chunks) - 1), **kw)
        snaps.append(snap)
        t += c
    return state, snaps


@pytest.mark.parametrize("algorithm,prob_domain", [("prefix", False),
                                                   ("reference", False),
                                                   ("reference", True)])
@pytest.mark.parametrize("chunks", [[5, 5, 5], [1, 7, 4, 3], [15]])
def test_streaming_matches_jax_and_batch(algorithm, prob_domain, chunks):
    T, B, V, W, L = sum(chunks), 3, 5, 6, 32
    lp = _lp(sum(chunks) * 7 + len(chunks), T, B, V)
    x = np.exp(lp) if prob_domain else lp
    kw = dict(algorithm=algorithm, prob_domain=prob_domain)
    state, snaps = _port_stream(x, W, L, chunks, **kw)
    got = snaps[-1]

    j_state = jbs.streaming_init(B, W, max_len=L,
                                 log_domain=not prob_domain)
    t = 0
    for i, c in enumerate(chunks):
        j_state, want = jbs.streaming_step(
            j_state, jnp.asarray(x[t:t + c]),
            is_final=(i == len(chunks) - 1), **kw)
        t += c
    _assert_same(got, want, log_domain=not prob_domain)
    assert state.frames == T == int(j_state.frames)

    batch = tbs.ctc_beam_search(torch.from_numpy(x), beam_width=W,
                                max_len=L, **kw)
    _assert_same(got, batch, log_domain=not prob_domain)


def _to_kernel_layout(buf, L):
    """[B, W, L] -> JAX's [B, Lp, 128] kernel layout (-1 padded)."""
    B, W, _ = buf.shape
    Lp = -(-(L + 1) // 8) * 8
    return jnp.asarray(np.pad(np.transpose(buf, (0, 2, 1)),
                              ((0, 0), (0, Lp - L), (0, 128 - W)),
                              constant_values=-1))


def _from_kernel_layout(buf, L, W):
    return np.transpose(np.asarray(buf)[:, :L, :W], (0, 2, 1))


@pytest.mark.parametrize("Tc0,Tc,B,W,V,L,blank_shift,random_base", [
    (6, 9, 2, 8, 6, 12, 0.0, False),     # Tc not a multiple of TBLK=8
    (5, 1, 3, 6, 5, 16, 0.0, False),     # Tc = 1
    (7, 10, 2, 16, 29, 8, -4.0, False),  # prefixes overflow L
    (4, 8, 3, 32, 7, 24, 0.0, True),     # arbitrary base rows
])
def test_traceback_overlay_plain_matches_pallas_interpret(
        Tc0, Tc, B, W, V, L, blank_shift, random_base):
    lp = torch.from_numpy(_lp(Tc0 * 31 + W, Tc0 + Tc, B, V, blank_shift))
    init = tbs._init_beam(B, W, "cpu")
    mid, ys0 = tbs._matched_scan(lp[:Tc0], init, 0)
    base_tok, base_ts, _ = tbs._traceback(ys0, mid.length, L)
    if random_base:
        rng = np.random.default_rng(W)
        base_tok = torch.from_numpy(rng.integers(-1, 30, (B, W, L),
                                                 dtype=np.int32))
        base_ts = torch.from_numpy(rng.integers(-1, 1000, (B, W, L),
                                                dtype=np.int32))
    fin, ys = tbs._matched_scan(lp[Tc0:], mid, 0)
    if blank_shift:
        assert int(fin.length.max()) > L    # emissions land past L
    t_offset = Tc0 + 100
    tok, ts, start = fused_decode.traceback_overlay_plain(
        ys, fin.length, base_tok, base_ts, t_offset)
    k_tok, k_ts, k_start = traceback_overlay_pallas(
        jnp.asarray(ys.numpy()), jnp.asarray(fin.length.numpy()), L,
        _to_kernel_layout(base_tok.numpy(), L),
        _to_kernel_layout(base_ts.numpy(), L), jnp.int32(t_offset),
        interpret=True)
    np.testing.assert_array_equal(tok.numpy(), _from_kernel_layout(k_tok, L,
                                                                   W))
    np.testing.assert_array_equal(ts.numpy(), _from_kernel_layout(k_ts, L, W))
    np.testing.assert_array_equal(start.numpy(), np.asarray(k_start))
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(fused_decode.traceback_overlay(
            ys, fin.length, base_tok, base_ts, t_offset), (tok, ts, start)):
        assert torch.equal(a, b)


def test_streaming_active_len_equals_default():
    rng = np.random.default_rng(42)
    for chunks, B, V, W, L in [([5, 5, 5], 3, 5, 6, 64),
                               ([20, 20, 20, 20], 4, 7, 8, 128),
                               ([1, 9, 2, 8], 2, 6, 4, 96)]:
        lp = _log_softmax(rng.standard_normal((sum(chunks), B, V)))
        sa = tbs.streaming_init(B, W, max_len=L, device="cpu")
        sb = tbs.streaming_init(B, W, max_len=L, device="cpu")
        t = 0
        for c in chunks:
            chunk = torch.from_numpy(lp[t:t + c])
            la = min(L, -(-(t + c) // 16) * 16)
            sa, ra = tbs.streaming_step(sa, chunk, active_len=la)
            sb, rb = tbs.streaming_step(sb, chunk)
            t += c
            assert torch.equal(sa.tokens, sb.tokens)
            assert torch.equal(sa.timesteps, sb.timesteps)
            for f in ra._fields:
                assert torch.equal(getattr(ra, f), getattr(rb, f)), f


def test_streaming_snapshots_stay_valid_after_later_chunks():
    T, B, V, W, L = 12, 2, 4, 4, 16
    lp = _lp(0, T, B, V)
    _, snaps = _port_stream(lp, W, L, [4, 4, 4])
    kept = [tuple(x.clone() for x in s) for s in snaps]
    for t_end, snap, copy in zip((4, 8, 12), snaps, kept):
        # later chunks wrote nothing into an earlier snapshot's tensors
        for a, b in zip(snap, copy):
            assert torch.equal(a, b)
        want = tbs.ctc_beam_search(torch.from_numpy(lp[:t_end]),
                                   beam_width=W, max_len=L)
        assert [ids for ids, _ in tbs.decode_to_lists(snap)] == \
            [ids for ids, _ in tbs.decode_to_lists(want)]
        want_j = jbs.ctc_beam_search(jnp.asarray(lp[:t_end]), beam_width=W,
                                     max_len=L)
        _assert_same(snap, want_j, fields=("tokens", "lengths"))


def test_streaming_pallas_on_cpu_runs_the_plain_path():
    T, B, V, W, L = 24, 2, 29, 16, 8
    lp = _lp(99, T, B, V, blank_shift=-4.0)
    full = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                               max_len=L, merge_impl="pallas")
    assert bool(full.overflow.any())
    _, snaps = _port_stream(lp, W, L, [9, 1, 14], merge_impl="pallas")
    for f in full._fields:
        assert torch.equal(getattr(snaps[-1], f), getattr(full, f)), f
    state = tbs.streaming_init(1, 65, max_len=L, device="cpu")
    with pytest.raises(ValueError, match="W <= 64 and V <= 256"):
        tbs.streaming_step(state, torch.zeros(2, 1, 129),
                           merge_impl="pallas")


def test_streaming_large_chunk_equals_batch():
    T, B, V, W, L = 200, 2, 5, 6, 64
    lp = _lp(11, T, B, V)
    full = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                               max_len=L)
    _, snaps = _port_stream(lp, W, L, [150, 50])
    for f in full._fields:
        assert torch.equal(getattr(snaps[-1], f), getattr(full, f)), f


def test_streaming_timesteps_absolute():
    lp2 = np.full((6, 1, 3), -20.0, np.float32)
    lp2[[0, 2, 3, 5], 0, 0] = -0.001
    lp2[1, 0, 1] = -0.001               # 'a' frame 1
    lp2[4, 0, 2] = -0.001               # 'b' frame 4 (second chunk)
    _, snaps = _port_stream(lp2, 2, 8, [3, 3])
    assert snaps[-1].tokens[0, 0, :2].tolist() == [1, 2]
    assert snaps[-1].timesteps[0, 0, :2].tolist() == [0, 4]


@pytest.mark.parametrize("layers", [1, 2])
def test_rnn_forward_streaming_matches_full_and_jax(layers):
    from gasr_tpu.ops.rnn import rnn_forward_streaming as j_streaming
    T, B, F, H = 11, 3, 10, 16
    jp = jax.device_get(rnn_init(jax.random.PRNGKey(layers), F, H, layers))
    tp = params_from_jax(jp)
    x = np.random.default_rng(3).standard_normal((T, B, F)).astype(
        np.float32)
    full = rnn_forward(tp, torch.from_numpy(x), impl="scan")
    outs, h = [], None
    for lo, hi in ((0, 4), (4, 5), (5, 11)):
        out, h = rnn_forward_streaming(tp, torch.from_numpy(x[lo:hi]), h)
        outs.append(out)
    got = torch.cat(outs)
    torch.testing.assert_close(got, full, atol=0, rtol=0)
    assert h.shape == (layers, B, H)
    torch.testing.assert_close(h[-1], full[-1], atol=0, rtol=0)
    want = np.asarray(j_rnn_forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    j_out, j_h = j_streaming(jp, jnp.asarray(x[:4]))
    out, h = rnn_forward_streaming(tp, torch.from_numpy(x[:4]))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(j_h), atol=1e-5,
                               rtol=0)


def test_rnn_forward_streaming_rejects_bidirectional():
    with pytest.raises(ValueError, match="bidirectional"):
        rnn_forward_streaming({"layers": [], "layers_rev": []},
                              torch.zeros(2, 1, 3))


def _small_pair(**over):
    base = dict(batch_size=3, seg_len=24, linear_size=32, rnn_hidden_size=32,
                vocab_size=9, beam_width=6, decode_max_len=16)
    base.update(over)
    jc = dataclasses.replace(jcfg.PRESETS["reference_large"], **base)
    tc = dataclasses.replace(tcfg.PRESETS["reference_large"], device="cpu",
                             **base)
    return jc, tc


def test_deepspeech_apply_streaming_matches_full_and_jax():
    jc, tc = _small_pair()
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(1)))
    tp = params_from_jax(jp)
    x = np.random.default_rng(2).uniform(
        size=(3, 24, tc.feat_size)).astype(np.float32)
    full = deepspeech_apply(tp, torch.from_numpy(x))
    outs, st, j_outs, j_st = [], None, [], None
    for lo, hi in ((0, 7), (7, 8), (8, 24)):
        out, st = deepspeech_apply_streaming(tp, torch.from_numpy(
            x[:, lo:hi]), st)
        outs.append(out)
        j_out, j_st = j_ds_streaming(jp, jnp.asarray(x[:, lo:hi]), j_st)
        j_outs.append(np.asarray(j_out))
    got = torch.cat(outs)
    assert got.shape == (24, 3, tc.output_size)
    # chunked equals full up to the GEMMs' row-count-dependent blocking
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.concatenate(j_outs),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=1e-5,
                               rtol=0)


def test_pipeline_transcribe_streaming_matches_jax_and_transcribe():
    jc, tc = _small_pair(vocab_size=28)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(4)))
    x = np.random.default_rng(5).uniform(
        size=(3, 24, tc.feat_size)).astype(np.float32)
    chunks = [x[:, :10], x[:, 10:11], x[:, 11:]]
    want = JPipeline(jc, params=jp).transcribe_streaming(
        [jnp.asarray(c) for c in chunks])
    pipe = Pipeline(tc, params=params_from_jax(jp))
    got = pipe.transcribe_streaming(chunks)
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-4, atol=1e-4)
    one_shot = pipe.transcribe(x)
    assert [ids for ids, _ in got] == [ids for ids, _ in one_shot]
    np.testing.assert_allclose([s for _, s in got],
                               [s for _, s in one_shot], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("over", [{"model": "bilstm"},
                                  {"bidirectional": True}])
def test_pipeline_streaming_rejects_non_streamable(over):
    cfg = dataclasses.replace(tcfg.PRESETS["reference_toy"], device="cpu",
                              **over)
    pipe = Pipeline(cfg, params={})
    with pytest.raises(ValueError, match="streaming"):
        pipe.transcribe_streaming([np.zeros((3, 4, cfg.feat_size),
                                            np.float32)])
