"""The conformer family's FastConformer preset (`parakeet_ctc_1.1b`,
`models/conformer.py`) and the decoder's one-card vocab-sharded
dispatch, on the CPU:
  - the port against the benchmark's plain reference
    (`asrbench/reference/fastconformer.py`) on the same seeded weights at
    a small size (d 64, 2 blocks, 2 heads, kernel 9, 64 stem channels,
    V 40 + blank last, T 96), in float32 and in bf16;
  - each piece the preset adds, alone against the reference's piece, and
    the two sides parted where the piece is taken from one of them, so
    that the agreement says something about it;
  - conformer_l unchanged: a small conformer_l gives bit for bit what the
    tree before the preset gave (`golden/conformer_l_small.npz`);
  - `ctc_beam_search` past the decode kernel's shape rule: the one-card
    vocab-sharded scan (`tp_frames`; on CPU tensors its plain version)
    equal to `merge_impl="matched"`, and the rule that picks it.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from asrbench import weights as bench_weights
from asrbench.reference import decoder as ref_decoder
from asrbench.reference import fastconformer as ref
from gasr_tpu_torch.config import PRESETS, Config
from gasr_tpu_torch.decoder import beam_search as bs
from gasr_tpu_torch.models import conformer as tconf
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.ops import attention
from gasr_tpu_torch.ops.conv import conv_mixed
from gasr_tpu_torch.ops.cuda import fused_decode
from gasr_tpu_torch.runtime.profiler import records

ROOT = Path(__file__).resolve().parents[1]
NAME = "parakeet_ctc_1.1b"
SMALL = dict(d_model=64, num_blocks=2, num_heads=2, stem_channels=64)
V, BLANK, T, F = 40, 40, 96, 80
MODEL = dict(feat_size=F, ff_mult=4, conv_kernel=9, vocab_size=V, **SMALL)
# float32 on both sides: the same expressions summed in another order
F32_TOL = 1e-5


@pytest.fixture
def small(monkeypatch):
    """The preset at the small size: (config, weights, inputs)."""
    monkeypatch.setitem(tconf._PRESETS, NAME,
                        dict(tconf._PRESETS[NAME], **SMALL))
    cfg = Config(model=NAME, input_size=F, n_context=0, linear_size=64,
                 vocab_size=V, blank_id=BLANK, beam_width=8, device="cpu")
    params = bench_weights.make("fastconformer", MODEL,
                                torch.Generator().manual_seed(22), "cpu")
    x = torch.rand(3, T, F, generator=torch.Generator().manual_seed(23))
    return cfg, params, x


def _gap(a, b) -> float:
    return float((a - b).abs().max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_the_reference(small, dtype):
    cfg, params, x = small
    want = ref.apply(params, x, MODEL, "f32")
    assert want.shape == (ref.output_frames(T), 3, V + 1) == (12, 3, 41)
    if dtype == "f32":
        got = model_apply(cfg, params, x)
        assert _gap(got, want) <= F32_TOL
        return
    got = model_apply(cfg, params, x, compute_dtype=torch.bfloat16)
    # bf16: the port rounds each product's operands (as the reference at
    # "bf16" does) and also each product's output and the residual stream
    # to bf16 (8 bits of mantissa, about 4e-3 relative); over two blocks
    # at this size that gave 0.014 at most and 0.0032 rms against float32
    d = (got - want).double()
    assert float(d.abs().max()) <= 0.05
    assert float(d.pow(2).mean().sqrt()) <= 0.01
    # and it is rounding that separates them: far above float32's gap
    assert float(d.abs().max()) > 100 * F32_TOL


def _stem_piece(params, x, drop):
    """(port, reference) of the stem and its linear; `drop` replaces the
    reference's padding (1, 1) by lax "SAME"'s, which differs on even
    lengths."""
    got = tconf._lin(params["sub_proj"], tconf._dw_striding(params, x, None),
                     None)
    if drop:
        sub = {k: v for k, v in params.items() if k.startswith("sub")}
        h = x[..., None]
        C = sub["sub1"]["w"].shape[-1]
        for name, stride, groups, relu in (
                ("sub1", 2, 1, True), ("sub2_dw", 2, C, False),
                ("sub2_pw", 1, 1, True), ("sub3_dw", 2, C, False),
                ("sub3_pw", 1, 1, True)):
            h = conv_mixed(h, sub[name]["w"], (stride, stride), "SAME",
                           groups) + sub[name]["b"]
            h = h.relu() if relu else h
        B, Tp, Fp, _ = h.shape
        h = h.reshape(B, Tp, Fp * C)
    else:
        h = ref._stem(params, x, "f32")
    return got, ref._lin(params["sub_proj"], h, "f32")


def _xscaling_piece(params, x, drop, cfg, monkeypatch):
    got = model_apply(cfg, params, x)
    if drop:
        monkeypatch.setitem(tconf._PRESETS, NAME,
                            dict(tconf._PRESETS[NAME], xscaling=False))
        got = model_apply(cfg, params, x)
    return got, ref.apply(params, x, MODEL, "f32")


def _bias_piece(params, x, drop):
    p = params["blocks"][0]["mhsa"]
    h = torch.randn(20, 2, 64, generator=torch.Generator().manual_seed(5))
    mine = ({k: v for k, v in p.items() if k not in ("bq", "bk", "bv", "bo")}
            if drop else p)
    return (attention.mhsa_rel(mine, h, 2, impl="xla"),
            ref._mhsa(p, h, 2, "f32"))


def _batch_norm_piece(params, x, drop):
    p = params["blocks"][0]["conv"]
    h = torch.randn(20, 2, 64, generator=torch.Generator().manual_seed(6))
    mine = dict(p, bn=dict(p["bn"], mean=torch.zeros(64),
                           var=torch.ones(64))) if drop else p
    return tconf._convmod(mine, h, 9), ref._conv_module(p, h, "f32")


def _blank_last_piece(params, x, drop, cfg):
    lp = model_apply(cfg, params, x)
    lens = torch.tensor([12, 9, 5], dtype=torch.int32)
    blank = 0 if drop else BLANK
    res = bs.ctc_beam_search(lp, 8, blank_id=blank, input_lengths=lens)
    got = bs.decode_to_lists(res)
    want = ref_decoder.decode(ref_decoder.pad_blank(lp, lens, BLANK), 8,
                              [lp.shape[0]], BLANK)[lp.shape[0]]
    if not drop:
        assert [t for t, _ in got] == [t for t, _ in want]
        assert all(BLANK not in tok for tok, _ in got)
    return (torch.tensor([s for _, s in got]),
            torch.tensor([s for _, s in want]))


PIECES = {
    "stem": lambda p, x, drop, cfg, mp: _stem_piece(p, x, drop),
    "xscaling": _xscaling_piece,
    "biases": lambda p, x, drop, cfg, mp: _bias_piece(p, x, drop),
    "batch_norm": lambda p, x, drop, cfg, mp: _batch_norm_piece(p, x, drop),
    "blank_last": lambda p, x, drop, cfg, mp: _blank_last_piece(p, x, drop,
                                                                cfg),
}


@pytest.mark.parametrize("piece", sorted(PIECES))
def test_each_piece_matches_the_references(small, piece, monkeypatch):
    cfg, params, x = small
    got, want = PIECES[piece](params, x, False, cfg, monkeypatch)
    assert got.shape == want.shape
    assert _gap(got, want) <= F32_TOL, piece
    # with the piece taken from one side, the two part well past it
    got, want = PIECES[piece](params, x, True, cfg, monkeypatch)
    assert got.shape != want.shape or _gap(got, want) > 1e3 * F32_TOL, piece


def test_the_preset_has_the_published_widths_and_size():
    conf = json.loads((ROOT / "asrbench/configs/parakeet_ctc_1.1b.json")
                      .read_text())
    hp = tconf._preset(Config(model=NAME, linear_size=1024))
    m = conf["model"]
    assert (hp["d_model"], hp["num_blocks"], hp["num_heads"],
            hp["ff_mult"], hp["conv_kernel"], hp["stem_channels"]) == (
        m["d_model"], m["num_blocks"], m["num_heads"], m["ff_mult"],
        m["conv_kernel"], m["stem_channels"]) == (1024, 42, 8, 4, 9, 256)
    assert (hp["stem"], hp["xscaling"], hp["attn_bias"], hp["conv_norm"]) \
        == ("dw_striding", True, True, "batch")
    assert conf["program"]["blank_id"] == conf["program"]["vocab_size"] \
        == 1024 and conf["reduced"] == []
    n = sum(math.prod(s) for _, s, _, _ in ref.spec(m))
    assert 1.05e9 < n < 1.09e9, n            # "1.1B": 1.07 B published
    # every conformer keeps the Conformer's features
    for other in ("conformer_s", "conformer_l", "conformer"):
        hp = tconf._preset(Config(model=other))
        assert (hp["stem"], hp["xscaling"], hp["attn_bias"],
                hp["conv_norm"]) == ("conv", False, False, "layer")


def test_init_has_the_benchmarks_layout(small):
    cfg, params, _ = small
    mine = tconf.conformer_init(torch.Generator().manual_seed(0), cfg)
    shapes = {k: tuple(v.shape) for k, v in bench_weights.leaves(mine)}
    assert shapes == {k: tuple(v.shape)
                      for k, v in bench_weights.leaves(params)}


GOLDEN = ROOT / "tests/golden/conformer_l_small.npz"


@pytest.mark.parametrize("route", ["", "_xla", "_pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conformer_l_is_bit_for_bit_unchanged(dtype, route):
    g = np.load(GOLDEN)
    cfg = dataclasses.replace(PRESETS["conformer_l"], linear_size=64,
                              num_blocks=2, vocab_size=16, device="cpu")
    params = model_init(cfg, torch.Generator().manual_seed(22))
    kw = {"attn_impl": route[1:]} if route else {}
    out = model_apply(cfg, params, torch.from_numpy(g["x"]),
                      compute_dtype=torch.bfloat16 if dtype == "bf16"
                      else None, **kw)
    want = g[dtype + route]
    assert out.numpy().view(np.int32).tolist() == \
        want.view(np.int32).tolist()


@pytest.mark.parametrize("vocab", [300, 1025])
def test_vocab_sharded_scan_equals_the_matched_scan(vocab):
    Tn, B, W = 14, 3, 16
    blank = vocab - 1
    g = torch.Generator().manual_seed(vocab)
    lp = torch.log_softmax(3 * torch.randn(Tn, B, vocab, generator=g), -1)
    lens = torch.tensor([14, 9, 5], dtype=torch.int32)
    want = bs.ctc_beam_search(lp, W, blank_id=blank, merge_impl="matched",
                              input_lengths=lens)
    # the length mask ctc_beam_search applies before either scan
    past = torch.arange(Tn)[:, None] >= lens[None, :]
    certain = torch.where(torch.arange(vocab) == blank, 0.0, bs.NEG_INF)
    masked = torch.where(past[:, :, None], certain, lp)
    before = fused_decode.tp_frame_launches
    fin, ys = bs._vocab_sharded_scan(masked, bs._init_beam(B, W, "cpu"),
                                     blank)
    tokens, timesteps, _ = fused_decode.traceback(ys, fin.length, 256)
    got = bs._result(fin, tokens, timesteps, 256)
    assert fused_decode.tp_frame_launches == before   # the plain version
    for name in ("tokens", "lengths", "timesteps", "overflow"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.scores.view(torch.int32),
                       want.scores.view(torch.int32))
    assert (want.tokens != blank).all()


CUDA = torch.device("cuda")


@pytest.mark.parametrize("case,want", [
    (dict(W=100, V=47), False),            # ds1: the decode kernel
    (dict(W=16, V=129), False),            # conformer_l: the decode kernel
    (dict(W=64, V=256), False),            # the kernel's envelope corner
    (dict(W=16, V=1025), True),            # parakeet_ctc_1.1b
    (dict(W=16, V=300), True),
    (dict(W=128, V=200), True),            # W past 64 at V > 128
    (dict(W=129, V=1025), False),          # W past the frame kernel
    (dict(W=16, V=1025, device=torch.device("cpu")), False),
    (dict(W=16, V=1025, merge_impl="matched"), False),
    (dict(W=16, V=1025, has_lm=True), False),
    (dict(W=16, V=1025, algorithm="reference"), False),
])
def test_the_vocab_sharded_rule(case, want):
    kw = dict(merge_impl="auto", algorithm="prefix", log_domain=True,
              device=CUDA, has_lm=False)
    kw.update(case)
    assert bs._use_vocab_shards(kw["merge_impl"], kw["algorithm"],
                                kw["log_domain"], kw["W"], kw["V"],
                                kw["device"], kw["has_lm"]) is want
    assert bs._vocab_shard_count(1025) == 9


def test_the_stem_and_the_shards_have_their_spans(small):
    cfg, params, x = small
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        lp = model_apply(cfg, params, x)
        bs._vocab_sharded_scan(lp[:3], bs._init_beam(3, 4, "cpu"), BLANK)
    spans = [s for s in records().spans if s.name != "gc"]
    # a span's parent: the innermost earlier span whose interval holds it
    tree = [(s.name, next((p.name for p in reversed(spans[:i])
                           if p.start_ns <= s.start_ns
                           and s.end_ns <= p.end_ns), None))
            for i, s in enumerate(spans)]
    assert ("model.stem", "model.forward") in tree
    assert ("decode.vocab_shards", None) in tree
