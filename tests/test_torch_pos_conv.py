"""wav2vec 2.0's positional convolution with its bias and GELU
(`ops/cuda/pos_conv.py`, `csrc/pos_conv.cu`).

On the CPU:
  - `pos_conv_plain` (the kernel's function: a float32 sum over the taps,
    rounded once) against the model's eager chain (`conv1d_nwc` padded by
    K // 2, `.add_(b)`, the slice to T' frames, F.gelu) at small shapes
    with ragged T' (under 64, not a multiple of the kernel's 512-frame
    tile, B = 1, an odd K), in float32 and bf16;
  - the rule: CPU tensors, float32 compute, inputs under autograd, stride
    above 1, groups of other widths (the feature encoder's convolutions,
    groups 1) and the conformers' depthwise shape keep the eager chain;
  - a CPU wav2vec2 forward at 64 channels a group launches nothing; the
    wrapper refuses a CPU tensor.
Marked `cuda` (every such test skips without a card): the kernel against
a float64 convolution of the same bf16 operands at the benchmark cell's
shape (B 64, T' 999, d 1024, K 128, 16 groups) and at T' = 1, 63, 257 and
B = 1, each rounded sum within one bf16 ulp of it (plus the float32 sum's
own slack), the bias and GELU bit-equal to `.add_(b)` and F.gelu on the
kernel's own rounded sums; a bf16 `wav2vec2_large_lv60` forward cut to
two layers counts one `pos_conv` launch and its log-probs stay within the
cell's `lp_gap_t0` / `lp_rms` limits (0.08 / 0.022) of the cuDNN route's;
the wrapper's refusals.

This file imports no JAX, so on a machine without JAX its card tests run
as
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_pos_conv.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.models import wav2vec2 as w2v
from gasr_tpu_torch.ops.conv import conv1d_nwc
from gasr_tpu_torch.ops.cuda import launch_counts
from gasr_tpu_torch.ops.cuda import pos_conv as kpc

BF16 = torch.bfloat16


def _inputs(B, T, G, K, seed, device="cpu", dtype=BF16):
    """h [B, T, 64 G], w [K, 64, 64 G] at the scale of the model's (the
    sums near 1), b [64 G], at dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    C = 64 * G
    h = torch.randn((B, T, C), generator=gen, device=device)
    w = torch.randn((K, 64, C), generator=gen, device=device) / math.sqrt(
        64 * K)
    b = torch.randn((C,), generator=gen, device=device) * 0.5
    return h.to(dtype), w.to(dtype), b.to(dtype)


def _chain(h, w, b, groups, act="gelu"):
    # the model's eager chain before the kernel
    K, T = w.shape[0], h.shape[1]
    y = conv1d_nwc(h, w, 1, (K // 2, K // 2), groups).add_(b)[:, :T]
    return F.gelu(y) if act == "gelu" else y


def _within_an_ulp(got, want, slack):
    """|got - want| <= one bf16 ulp of want + slack, everywhere."""
    w = want.double()
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        w.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got.double() - w).abs() <= ulp + slack).all())


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int16), b.contiguous().view(torch.int16))


# (B, T', groups, K): T' under 64, under a tile, past one; B = 1; odd K
SMALL = [(2, 37, 2, 16), (1, 63, 1, 128), (1, 70, 2, 7), (3, 5, 1, 128),
         (2, 1, 3, 4)]


@pytest.mark.parametrize("B,T,G,K", SMALL)
def test_plain_against_the_eager_chain_in_float32(B, T, G, K):
    h, w, b = _inputs(B, T, G, K, B + T + K, dtype=torch.float32)
    want = _chain(h, w, b, G)
    got = kpc.pos_conv_plain(h, w, b)
    assert got.dtype == torch.float32 and got.shape == (B, T, 64 * G)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("B,T,G,K", SMALL)
def test_plain_against_the_eager_chain_in_bf16(B, T, G, K):
    h, w, b = _inputs(B, T, G, K, B + T + K)
    z = torch.zeros_like(b)
    # the rounded sums: float32 sums of the same exact products, in
    # another order, each rounded once
    pre = kpc.pos_conv_plain(h, w, z, "none")
    assert _within_an_ulp(pre, _chain(h, w, z, G, "none"), 1e-6)
    # where the sums agree, so do the sums with the bias
    same = pre == _chain(h, w, z, G, "none")
    assert _bits_equal(kpc.pos_conv_plain(h, w, b, "none")[same],
                       _chain(h, w, b, G, "none")[same])
    # and the GELU after them is F.gelu's (the CPU's F.gelu rounds a
    # strided input, as the chain's slice is, apart from a contiguous one in
    # the last bit of a few values: compared on contiguous tensors)
    assert _bits_equal(kpc.pos_conv_plain(h, w, b), F.gelu(pre.add_(b)))


def test_plain_refuses_an_unknown_act():
    h, w, b = _inputs(1, 4, 1, 2, 0)
    with pytest.raises(ValueError, match="unknown act"):
        kpc.pos_conv_plain(h, w, b, "relu")


def _rule_case(name):
    """(h, w, b, stride, groups) and whether the kernel takes its shape
    (`_takes`, whatever the device)."""
    h, w, b = _inputs(2, 37, 2, 16, 3)
    z = lambda *s, dt=BF16: torch.zeros(s, dtype=dt)  # noqa: E731
    return {
        "pos_conv": (h, w, b, 1, 2, True),
        "odd_k": (h, w[:15], b, 1, 2, True),
        "float32": (h.float(), w.float(), b.float(), 1, 2, False),
        "stride_2": (h, w, b, 2, 2, False),
        # wav2vec 2.0's feature encoder: layer 0 (1 -> 512, k 10, s 5) and
        # the layers after it (512 -> 512, k 3, s 2), groups 1; and a
        # stride-1 convolution of one 512-channel group
        "encoder_0": (z(2, 1600, 1), z(10, 1, 512), z(512), 5, 1, False),
        "encoder_1": (z(2, 319, 512), z(3, 512, 512), z(512), 2, 1, False),
        "groups_1_512": (z(2, 40, 512), z(3, 512, 512), z(512), 1, 1,
                         False),
        # the conformers' depthwise convolution (conv_mixed, groups = C)
        "depthwise": (z(2, 50, 512), z(31, 1, 512), z(512), 1, 512, False),
        "width_32": (z(2, 40, 128), z(16, 32, 128), z(128), 1, 4, False),
        "too_many_taps": (h, z(kpc.MAX_TAPS + 1, 64, 128), b, 1, 2, False),
        "strided_h": (h.transpose(0, 1).contiguous().transpose(0, 1), w, b,
                      1, 2, False),
        "b_shape": (h, w, b[:64], 1, 2, False),
        "b_float32": (h, w, b.float(), 1, 2, False),
        "empty_t": (h[:, :0], w, b, 1, 2, False),
    }[name]


RULE_CASES = ["pos_conv", "odd_k", "float32", "stride_2", "encoder_0",
              "encoder_1", "groups_1_512", "depthwise", "width_32",
              "too_many_taps", "strided_h", "b_shape", "b_float32",
              "empty_t"]


@pytest.mark.parametrize("name", RULE_CASES)
def test_the_shapes_the_kernel_takes(name):
    h, w, b, stride, groups, ok = _rule_case(name)
    assert (kpc._takes(h, w, b, stride, groups) is None) == ok
    # on the CPU nothing is eligible
    assert not kpc.pos_conv_eligible(h, w, b, stride, groups)


@pytest.mark.parametrize("case", ["cpu_bf16", "cpu_f32", "grad_bf16"])
def test_the_rule_keeps_the_eager_chain(case):
    dt = torch.float32 if case == "cpu_f32" else BF16
    h, w, b = _inputs(2, 37, 2, 16, 4, dtype=dt)
    if case == "grad_bf16":
        w.requires_grad_(True)
        assert kpc._records(h, w, b)
        with torch.no_grad():
            assert not kpc._records(h, w, b)
    before = kpc.launches
    got = kpc.conv_gelu(h, w, b, 2)
    assert kpc.launches == before
    assert got.dtype == dt and torch.equal(got, _chain(h, w, b, 2))
    assert got.requires_grad == (case == "grad_bf16")


def test_a_cpu_wav2vec2_forward_launches_nothing(monkeypatch):
    # 64 channels a group, the kernel's width: on the CPU the eager chain
    monkeypatch.setitem(w2v._PRESETS, "w2v_pos_test", dict(
        d_model=128, num_blocks=1, num_heads=2, ffn_dim=128,
        conv_dim=(32,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2), pos_kernel=16, pos_groups=2))
    cfg = Config(model="w2v_pos_test", input_size=160, n_context=0,
                 linear_size=128, rnn_hidden_size=128, vocab_size=7,
                 batch_size=2, seg_len=30, mesh_shape={}, device="cpu")
    params = w2v.wav2vec2_init(torch.Generator().manual_seed(0), cfg)
    x = torch.rand(2, 30, 160, generator=torch.Generator().manual_seed(1))
    before = launch_counts()
    with torch.no_grad():
        lp = w2v.wav2vec2_apply(cfg, params, x, compute_dtype=BF16)
    assert launch_counts() == before
    assert lp.shape == (w2v.output_length(30 * 160), 2, 8)
    assert bool(torch.isfinite(lp).all())


def test_the_wrapper_refuses_a_cpu_tensor():
    h, w, b = _inputs(1, 8, 1, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        kpc.pos_conv(h, w, b)


# --- on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _conv64(h, w, lo):
    """The convolution in float64 on the card: h [B, T, C], w [K, 64, C]
    (both cast from their bf16 values) -> [B, T, C], zero padding lo
    before."""
    B, T, C = h.shape
    K = w.shape[0]
    x = F.pad(h.double().permute(0, 2, 1), (lo, K - 1 - lo))
    y = F.conv1d(x, w.double().permute(2, 1, 0), groups=C // 64)
    return y.permute(0, 2, 1)


# (B, T', rows checked): the cell's shape (three utterances checked in
# float64), T' of one frame, under a 64-frame half window, past a tile
# boundary, and B = 1
CARD = [(64, 999, (0, 31, 63)), (2, 1, None), (3, 63, None),
        (2, 257, None), (1, 999, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,rows", CARD)
def test_kernel_against_a_float64_convolution(dev, B, T, rows):
    h, w, b = _inputs(B, T, 16, 128, B * T, dev)
    z = torch.zeros_like(b)
    before = kpc.launches
    pre = kpc.pos_conv(h, w, z, "none")
    out = kpc.pos_conv(h, w, b)
    torch.cuda.synchronize()
    assert kpc.launches == before + 2
    assert pre.shape == h.shape and pre.is_contiguous() and pre.dtype == BF16
    idx = list(rows) if rows else list(range(B))
    want = _conv64(h[idx], w, 64)
    # one ulp of the float64 value (0.5 for the rounding, the rest for
    # the float32 sum), and the float32 sum's own error where the terms
    # cancel: 2^-20 of the sum of |products| (8192 terms)
    slack = _conv64(h[idx].abs(), w.abs(), 64) * 2.0 ** -20
    assert _within_an_ulp(pre[idx], want, slack)
    assert _bits_equal(out, F.gelu(pre.clone().add_(b)))


@pytest.mark.cuda
def test_a_bf16_forward_launches_it_once_and_stays_near_cudnn(
        dev, monkeypatch):
    cfg = Config(model="wav2vec2_large_lv60", input_size=160, n_context=0,
                 linear_size=1024, rnn_hidden_size=1024, vocab_size=31,
                 num_blocks=2, batch_size=4, seg_len=2000, mesh_shape={},
                 device="cuda")
    params = model_init(cfg, torch.Generator().manual_seed(8))
    x = torch.rand(4, 2000, 160, generator=torch.Generator().manual_seed(9))
    x = x.to(dev)
    with torch.no_grad():
        before = launch_counts()
        fast = model_apply(cfg, params, x, compute_dtype=BF16)
        torch.cuda.synchronize()
        after = launch_counts()
        monkeypatch.setattr(kpc, "pos_conv_eligible", lambda *a: False)
        slow = model_apply(cfg, params, x, compute_dtype=BF16)
        assert launch_counts()["pos_conv"] == after["pos_conv"]
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"pos_conv": 1, "flash_mhsa": 2, "bias_act": 2 * 3 + 1,
                     "add_ln": 7 + 1 + 1 + 2 * 2}, moved
    d = (fast - slow).double()
    assert float(d[0].abs().max()) <= 0.08
    assert math.sqrt(float((d * d).mean())) <= 0.022


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float32", "width", "taps", "strided",
                                  "act", "under_autograd"])
def test_the_wrapper_refuses_on_the_card(dev, case):
    h, w, b = _inputs(2, 40, 2, 16, 10, dev)
    if case == "float32":
        with pytest.raises(ValueError, match="bf16"):
            kpc.pos_conv(h.float(), w, b)
    elif case == "width":
        with pytest.raises(ValueError, match="64 channels"):
            kpc.pos_conv(h[..., :96].contiguous(), w[:, :, :96], b[:96])
    elif case == "taps":
        big = torch.zeros((kpc.MAX_TAPS + 2, 64, 128), dtype=BF16,
                          device=dev)
        with pytest.raises(ValueError, match="K <="):
            kpc.pos_conv(h, big, b)
    elif case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            kpc.pos_conv(h.transpose(0, 1).contiguous().transpose(0, 1),
                         w, b)
    elif case == "act":
        with pytest.raises(ValueError, match="act"):
            kpc.pos_conv(h, w, b, "swish")
    else:
        with pytest.raises(NotImplementedError, match="forward only"):
            kpc.pos_conv(h, w.requires_grad_(True), b)


def test_the_counter_is_registered():
    from gasr_tpu_torch.ops.cuda import COUNTERS
    assert COUNTERS["pos_conv"] == ("pos_conv", "launches")
    assert launch_counts()["pos_conv"] == kpc.launches

