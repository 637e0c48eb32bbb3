"""wav2vec 2.0 CTC (`models/wav2vec2.py`), the port's own family, at a
small size: d 64, 2 layers, 4 heads, FFN 128, encoder convolutions 32
wide at the published kernels and strides, a positional kernel of 16 in
4 groups, V 8.

On the CPU:
  - the port in float32 against the benchmark's plain reference
    (`asrbench/reference/wav2vec2.py`) on the benchmark's seeded weights;
  - the reference against `transformers.Wav2Vec2ForCTC` built at the same
    size (stable layer norm, "layer" feature norm) with the same weights,
    where `transformers` is installed: the reference follows the
    published model;
  - frames after the encoder against HF's `_get_feat_extract_output_lengths`
    for 1-35 s;
  - `conv1d_nwc` against torch's channels-first convolution; the
    position-free attention's eager route against its plain twin;
  - `Pipeline.transcribe_audio` equal to its three stages on the
    normalised frames, and the waveform front end's frames and lengths;
  - the spans of `transcribe_audio`'s forward; a CPU forward launches
    nothing.
Marked `cuda` (each skips without a card): the position-free flash
kernel against its plain twin at the benchmark cell's shape (B 64, H 16,
T' 999, d_h 64) and at ragged ones; `bias_act`'s GELU bit-equal to the
eager chain at widths 4096, 3072 and 1024 and for every bf16 value; a bf16
forward's launch counts.

This file imports no JAX, so on a machine without JAX its card tests run
as
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_wav2vec2.py
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import gasr_tpu_torch.models.wav2vec2 as w2v
from gasr_tpu_torch.config import Config
from gasr_tpu_torch.decoder import ctc_beam_search
from gasr_tpu_torch.decoder.beam_search import decode_to_lists
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.models import model_apply, model_init, model_input
from gasr_tpu_torch.ops import attention
from gasr_tpu_torch.ops.conv import conv1d_nwc
from gasr_tpu_torch.ops.cuda import bias_act as kba
from gasr_tpu_torch.ops.cuda import flash_mhsa as kfl
from gasr_tpu_torch.ops.cuda import launch_counts

from asrbench import weights
from asrbench.reference import wav2vec2 as ref

NAME = "wav2vec2_large_lv60"
KERNELS, STRIDES = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
SMALL = dict(d_model=64, num_blocks=2, num_heads=4, ffn_dim=128,
             conv_dim=(32,) * 7, conv_kernel=KERNELS, conv_stride=STRIDES,
             pos_kernel=16, pos_groups=4)
V = 7                                     # symbols; blank 0 makes V + 1 = 8
MODEL = dict(SMALL, feat_size=160, vocab_size=V,
             conv_dim=list(SMALL["conv_dim"]))
BF16 = torch.bfloat16
CONFIG_FILE = os.path.join(os.path.dirname(__file__), os.pardir, "asrbench",
                           "configs", f"{NAME}.json")


def _config(**kw) -> Config:
    """The program's Config as the benchmark builds it: the configuration
    file's `program` block, with `kw` over it."""
    with open(CONFIG_FILE) as f:
        program = json.load(f)["program"]
    return Config.from_dict(dict(program, **kw))


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(w2v._PRESETS, NAME, dict(SMALL))
    return _config(device="cpu", linear_size=64, vocab_size=V, batch_size=2,
                   seg_len=40)


def _params(seed, device="cpu"):
    """The benchmark's weights at the small size (`asrbench/weights.py`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return weights.make("wav2vec2", MODEL, gen, device)


def _x(B, T, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((B, T, 160), generator=gen).to(device)


def test_the_preset_is_registered():
    cfg = _config(device="cpu")
    assert (cfg.model, cfg.feat_size, cfg.output_size, cfg.blank_id) == \
        (NAME, 160, 32, 0)
    assert w2v._PRESETS[NAME]["num_blocks"] == 24
    assert model_input(NAME) == "waveform"
    assert model_input("conformer_l") == model_input("deepspeech") == \
        "logmel"


def test_port_matches_the_reference_in_float32(small):
    p = _params(3)
    x = _x(2, 40, 4)
    got = model_apply(small, p, x)
    want = ref.apply(p, x, MODEL, "f32")
    assert got.shape == want.shape == (ref.output_frames(40), 2, V + 1)
    # both are float32 throughout; they differ only in the order of the
    # sums (the conv channels-last against channels-first, q, k and v as
    # one product, the positional kernel's norm), each ~1e-7 relative, on
    # log-probs of a few units
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_a_bf16_forward_on_the_cpu_is_near_the_float32_one(small):
    p = _params(5)
    x = _x(2, 40, 6)
    lo = model_apply(small, p, x, compute_dtype=BF16)
    hi = model_apply(small, p, x)
    assert lo.dtype == torch.float32
    assert 0 < float((lo - hi).abs().max()) < 0.2


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def test_output_frames_match_hf():
    tr = _transformers()
    cfg = tr.Wav2Vec2Config(conv_dim=(32,) * 7, conv_kernel=KERNELS,
                            conv_stride=STRIDES, hidden_size=64,
                            num_hidden_layers=1, num_attention_heads=4,
                            intermediate_size=128)
    n = torch.tensor([16000 * s // 4 for s in range(4, 141)]
                     + [16000 * 20 + k for k in range(-7, 8)])
    want = tr.Wav2Vec2PreTrainedModel._get_feat_extract_output_lengths(
        type("M", (), {"config": cfg})(), n)
    assert [w2v.output_length(int(k)) for k in n] == want.tolist()
    frames = [int(k) // 160 for k in n if int(k) % 160 == 0]
    assert [ref.output_frames(f) for f in frames] == \
        [w2v.output_length(160 * f) for f in frames]
    assert ref.output_frames(2000) == 999


def _hf_state(p, tr_model):
    """The seeded tree's weights under `Wav2Vec2ForCTC`'s names."""
    sd = {}
    pre = "wav2vec2."
    for i, layer in enumerate(p["fe"]):
        c = f"{pre}feature_extractor.conv_layers.{i}."
        sd[c + "conv.weight"] = layer["w"].permute(2, 1, 0)
        sd[c + "conv.bias"] = layer["b"]
        sd[c + "layer_norm.weight"] = layer["ln"]["g"]
        sd[c + "layer_norm.bias"] = layer["ln"]["b"]
    fp = f"{pre}feature_projection."
    sd[fp + "layer_norm.weight"] = p["fp"]["ln"]["g"]
    sd[fp + "layer_norm.bias"] = p["fp"]["ln"]["b"]
    sd[fp + "projection.weight"] = p["fp"]["w"].t()
    sd[fp + "projection.bias"] = p["fp"]["b"]
    enc = f"{pre}encoder."
    pc = enc + "pos_conv_embed.conv."
    names = set(tr_model.state_dict())
    if pc + "parametrizations.weight.original0" in names:
        g, v = (pc + "parametrizations.weight.original0",
                pc + "parametrizations.weight.original1")
    else:
        g, v = pc + "weight_g", pc + "weight_v"
    sd[g] = p["pos"]["g"].reshape(1, 1, -1)
    sd[v] = p["pos"]["v"].permute(2, 1, 0)
    sd[pc + "bias"] = p["pos"]["b"]
    sd[enc + "layer_norm.weight"] = p["ln_out"]["g"]
    sd[enc + "layer_norm.bias"] = p["ln_out"]["b"]
    for i, blk in enumerate(p["layers"]):
        lp = f"{enc}layers.{i}."
        for hf, ours in (("layer_norm", "ln1"), ("final_layer_norm", "ln2")):
            sd[lp + hf + ".weight"] = blk[ours]["g"]
            sd[lp + hf + ".bias"] = blk[ours]["b"]
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("o", "out_proj")):
            sd[f"{lp}attention.{hf}.weight"] = blk["attn"]["w" + n].t()
            sd[f"{lp}attention.{hf}.bias"] = blk["attn"]["b" + n]
        for hf, ours in (("intermediate_dense", "w1"),
                         ("output_dense", "w2")):
            sd[f"{lp}feed_forward.{hf}.weight"] = blk["ff"][ours]["w"].t()
            sd[f"{lp}feed_forward.{hf}.bias"] = blk["ff"][ours]["b"]
    sd["lm_head.weight"] = p["proj"]["w"].t()
    sd["lm_head.bias"] = p["proj"]["b"]
    return sd


def test_the_reference_follows_hf_wav2vec2_for_ctc():
    tr = _transformers()
    cfg = tr.Wav2Vec2Config(
        vocab_size=V + 1, pad_token_id=0, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        hidden_act="gelu", feat_extract_activation="gelu",
        conv_dim=(32,) * 7, conv_kernel=KERNELS, conv_stride=STRIDES,
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        layer_norm_eps=1e-5, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, apply_spec_augment=False,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0)
    model = tr.Wav2Vec2ForCTC._from_config(cfg, attn_implementation="eager")
    model.eval()
    p = _params(7)
    sd = _hf_state(p, model)
    own = model.state_dict()
    assert set(own) - set(sd) <= {"wav2vec2.masked_spec_embed"}
    with torch.no_grad():
        for k, t in sd.items():
            assert own[k].shape == t.shape, k
            own[k].copy_(t)
        x = _x(3, 40, 8)
        logits = model(x.reshape(3, -1)).logits       # [B, T', V + 1]
    want = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    got = ref.apply(p, x, MODEL, "f32")
    assert got.shape == want.shape
    # the same float32 operations in another order (HF's conv weight
    # recomposed by its parametrization, its attention's head split)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride,pads,groups,cin", [
    (5, (0, 0), 1, 1), (2, (0, 0), 1, 24), (1, (8, 8), 4, 32),
    (2, (3, 1), 2, 8)])
def test_conv1d_nwc_is_the_channels_first_conv(stride, pads, groups, cin):
    gen = torch.Generator().manual_seed(cin + stride)
    x = torch.randn(2, 61, cin, generator=gen)
    w = torch.randn(5, cin // groups, 16, generator=gen)
    got = conv1d_nwc(x, w, stride, pads, groups)
    want = F.conv1d(F.pad(x.transpose(1, 2), pads), w.permute(2, 1, 0),
                    stride=stride, groups=groups).transpose(1, 2)
    assert got.is_contiguous() and got.dtype == x.dtype
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    lo = conv1d_nwc(x.to(BF16), w.to(BF16), stride, pads, groups)
    exact = F.conv1d(F.pad(x.to(BF16).float().transpose(1, 2), pads),
                     w.to(BF16).float().permute(2, 1, 0), stride=stride,
                     groups=groups).transpose(1, 2)
    assert lo.dtype == BF16 and torch.equal(lo, exact.to(BF16))


@pytest.mark.parametrize("cd", [None, BF16])
def test_position_free_attention_routes_agree(cd):
    gen = torch.Generator().manual_seed(11)
    p = attention.mhsa_init(gen, 64)
    for n in ("q", "k", "v", "o"):
        p["b" + n] = torch.randn(64, generator=gen) * 0.3
    x = torch.randn(37, 3, 64, generator=gen)
    eager = attention.mhsa(p, x, 4, cd, impl="xla")
    plain = attention.mhsa(p, x, 4, cd, impl="pallas")
    assert eager.dtype == plain.dtype == torch.float32
    # the plain twin rounds q, k, v and the attention to bf16 whatever cd
    # is: at bf16 compute the two are the same function
    tol = 1e-6 if cd is not None else 0.05
    torch.testing.assert_close(eager, plain, atol=tol, rtol=0)


def test_waveform_frames_normalise_each_utterance(small):
    pipe = Pipeline(small, params=model_init(small,
                                             torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    audio = [rng.uniform(-3, 5, n).astype(np.float32) for n in (1000, 481)]
    x, lens = pipe.audio_features(audio)
    assert x.shape == (2, 7, 160) and lens.tolist() == [7, 4]
    flat = x.reshape(2, -1).double()
    for b, a in enumerate(audio):
        u = flat[b, :len(a)]
        assert abs(float(u.mean())) < 1e-5
        assert abs(float(u.var(unbiased=False)) - 1) < 1e-5
        assert not flat[b, len(a):].any()


def test_transcribe_audio_equals_its_stages(small):
    params = _params(9)
    pipe = Pipeline(small, params=params)
    rng = np.random.default_rng(1)
    audio = [rng.uniform(-1, 1, n).astype(np.float32)
             for n in (6400, 5000, 3333)]
    got = pipe.transcribe_audio(audio)
    x = torch.zeros(3, 40, 160)
    for b, a in enumerate(audio):
        a = a.astype(np.float64)
        a = (a - a.mean()) / np.sqrt(a.var() + 1e-7)
        x.view(3, -1)[b, :len(a)] = torch.from_numpy(a).float()
    lens = torch.tensor([40, 32, 21], dtype=torch.int32)
    lp = model_apply(small, params, x)
    res = ctc_beam_search(lp, beam_width=small.beam_width, blank_id=0,
                          max_len=small.decode_max_len, input_lengths=lens)
    want = [pipe.to_text(ids) for ids, _ in decode_to_lists(res)]
    assert got == want and len(got) == 3


def test_spans_of_a_forward_and_of_the_front_end(small):
    from gasr_tpu_torch.runtime.profiler import records
    pipe = Pipeline(small, params=_params(2))
    audio = [np.zeros(4000, np.float32) + 0.1, np.ones(3000, np.float32)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe.transcribe_audio(audio)
    names = [s.name for s in records().spans]
    for n in ("model.forward", "model.feature_encoder", "model.pos_conv",
              "decode.search"):
        assert names.count(n) == 1, (n, names)


def test_a_cpu_forward_launches_nothing(small):
    before = launch_counts()
    model_apply(small, _params(1), _x(2, 40, 2), compute_dtype=BF16)
    assert launch_counts() == before


# --- on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, H, T, dh, seed, dev):
    """q, k, v [B, H, T, dh] as strided views of a time-major [T, B, 3D]
    qkv product (the model's)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = H * dh
    qkv = (torch.randn((T, B, 3 * D), generator=gen, device=dev)
           * 1.5).to(BF16)
    tb = lambda a: a.reshape(T, B, H, dh).permute(1, 2, 0, 3)  # noqa: E731
    return tb(qkv[..., :D]), tb(qkv[..., D:2 * D]), tb(qkv[..., 2 * D:])


def _close(got, want):
    tol = 0.02 * max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,dh,lens", [
    (64, 16, 999, 64, None), (3, 2, 130, 64, [130, 64, 0]),
    (2, 4, 65, 32, [1, 300]), (2, 2, 2, 48, None), (1, 8, 300, 128, [77]),
    (2, 3, 200, 24, None)])
@pytest.mark.parametrize("out_f32", [False, True])
def test_position_free_kernel_against_its_plain_twin(dev, B, H, T, dh, lens,
                                                      out_f32):
    q, k, v = _qkv(B, H, T, dh, T + dh, dev)
    lengths = torch.tensor(lens if lens else [T] * B, dtype=torch.int32,
                           device=dev)
    before = kfl.position_free_launches
    got = kfl.flash_mhsa(q, k, v, lengths, out_f32)
    torch.cuda.synchronize()
    assert kfl.position_free_launches == before + 1
    assert got.dtype == (torch.float32 if out_f32 else BF16)
    assert got.permute(2, 0, 1, 3).is_contiguous()
    _close(got, kfl.flash_mhsa_plain(q, k, v, lengths, True))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(63936, 4096), (63936, 3072),
                                    (63936, 1024), (333, 4096), (37, 16)])
def test_gelu_epilogue_is_bit_equal_to_the_eager_chain(dev, rows, n):
    gen = torch.Generator(device=dev).manual_seed(rows + n)
    y = torch.randn((rows, n), generator=gen, device=dev) * 3
    b = torch.randn((n,), generator=gen, device=dev) * 0.5
    before = kba.launches
    got = kba.bias_act(y, b, "gelu")
    assert kba.launches == before + 1
    want = F.gelu((y + b.to(BF16).float()).to(BF16))
    assert torch.equal(want, kba.bias_act_plain(y, b, "gelu", BF16))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_every_bf16_value_through_the_gelu(dev):
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    t = bits.to(torch.int16).view(BF16)
    t = t[~torch.isnan(t)].float()
    t = torch.cat([t, t.new_zeros(-t.numel() % 8)]).reshape(-1, 8)
    z = torch.zeros(8, device=dev)
    got = kba.bias_act(t, z, "gelu")
    # the eager chain: the bias add (which makes -0.0 + 0.0 = +0.0), the
    # rounding, F.gelu
    want = kba.bias_act_plain(t, z, "gelu", BF16)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got[~nan].view(torch.int16),
                       want[~nan].view(torch.int16))


@pytest.mark.cuda
def test_a_bf16_forward_counts_its_launches(dev, small):
    cfg = dataclasses.replace(small, device="cuda")
    params = _params(4, "cuda")
    x = _x(3, 40, 5, dev)
    before = launch_counts()
    with torch.no_grad():
        lp = model_apply(cfg, params, x, compute_dtype=BF16)
    torch.cuda.synchronize()
    after = launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    # a layer: flash 1, bias_act 3 (qkv, W1 + GELU, W2), add_ln 2; the
    # encoder's 7 norms, the projection's norm and linear, the first add
    assert moved == {"flash_mhsa": 2, "bias_act": 2 * 3 + 1,
                     "add_ln": 7 + 1 + 1 + 2 * 2}, moved
    want = ref.apply(params, x, MODEL, "f32")
    assert float((lp - want).abs().max()) < 0.2


@pytest.mark.cuda
def test_the_kernel_route_equals_the_eager_route_on_the_card(dev, small,
                                                            monkeypatch):
    cfg = dataclasses.replace(small, device="cuda")
    params = _params(6, "cuda")
    x = _x(2, 40, 7, dev)
    with torch.no_grad():
        fast = model_apply(cfg, params, x, compute_dtype=BF16)
        slow = model_apply(cfg, params, x, compute_dtype=BF16,
                           attn_impl="xla")
    # the kernel rounds the unnormalized probabilities to bf16, the eager
    # route the normalized ones: 2^-8 relative a score
    assert 0 < float((fast - slow).abs().max()) < 0.05
