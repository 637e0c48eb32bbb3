"""The epilogue of a conformer block linear (`ops/cuda/bias_act.py`,
`csrc/bias_act.cu`): the bias add, the rounding to bf16 and the swish or
GLU after it.

On the CPU:
  - `bias_act_plain` bit-equal to the model's eager expressions before the
    kernel (`linear`'s bias add, `.to(cd)`, the step-wise sigmoid), in the
    three forms, in bf16 and float32;
  - the rule: CPU tensors, float32 compute and inputs under autograd take
    the plain path, and the shapes and layouts the kernel refuses;
  - a CPU forward launches nothing; the wrapper refuses a CPU tensor.
Marked `cuda` (every such test skips without a card): the kernel bit-equal
to `bias_act_plain` at the benchmark cells' shapes, at conformer_s's
widths, at a ragged row count, and for every bf16 value that reaches the
sigmoid; a bf16 forward of conformer_l and of parakeet_ctc_1.1b cut to two
blocks counts 6 and 7 launches a block and 1 for the stem, and its
log-probs equal those of the same forward with the rule forced off; a
forward under autograd counts none; the refusals.

This file imports no JAX, so on a machine without JAX its card tests run
as
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_bias_act.py
"""

import dataclasses

import pytest
import torch

from gasr_tpu_torch.config import PRESETS, Config
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.ops.cuda import bias_act as kba
from gasr_tpu_torch.ops.linear import linear, linear_init, matmul

BF16 = torch.bfloat16


def _todays_sigmoid(x):
    # the model's `_sigmoid` before the kernel
    return 1.0 / (1.0 + torch.exp(-x))


def _todays(p, x, cd, act):
    # `_lin` (linear() re-emitted at cd), then the swish or GLU after it,
    # as the model wrote them before the kernel
    h = linear(p, x, None, cd)
    h = h if cd is None else h.to(cd)
    if act == "swish":
        return h * _todays_sigmoid(h)
    if act == "glu":
        a, b = h.chunk(2, dim=-1)
        return a * _todays_sigmoid(b)
    return h


def _inputs(din, n, seed, rows=(7, 3), device="cpu"):
    """x [T, B, din] as a block linear sees it, the linear's params (w
    [din, n], b [n]) with the bias widened so that it moves the sums."""
    gen = torch.Generator().manual_seed(seed)
    p = linear_init(gen, din, n)
    p["b"] = p["b"] * 8
    x = torch.randn(*rows, din, generator=gen) * 2
    return x.to(device), {k: v.to(device) for k, v in p.items()}


def _bits_equal(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == BF16:
        a, b = (t.contiguous().view(torch.int16) for t in (a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("cd", [BF16, None])
@pytest.mark.parametrize("act", ["none", "swish", "glu"])
def test_plain_is_the_models_expressions(cd, act):
    x, p = _inputs(48, 64, 1)
    want = _todays(p, x, cd, act)
    y = matmul(x, p["w"], cd)
    assert _bits_equal(kba.bias_act_plain(y, p["b"], act, cd), want)


def test_plain_refuses_an_unknown_act():
    with pytest.raises(ValueError, match="unknown act"):
        kba.bias_act_plain(torch.zeros(2, 8), torch.zeros(8), "relu", BF16)


@pytest.mark.parametrize("case", ["cpu_bf16", "cpu_f32", "grad_bf16"])
@pytest.mark.parametrize("act", ["none", "swish", "glu"])
def test_the_rule_takes_the_plain_path(case, act):
    cd = None if case == "cpu_f32" else BF16
    x, p = _inputs(32, 64, 2)
    if case == "grad_bf16":
        p = {k: v.requires_grad_(True) for k, v in p.items()}
    from gasr_tpu_torch.models import conformer as tconf
    y = torch.matmul(x, p["w"])
    assert not kba.bias_act_eligible(y, p["b"], act, cd)
    before = kba.launches
    got = tconf._lin(p, x, cd, act)
    assert kba.launches == before
    assert _bits_equal(got.detach(), _todays(p, x, cd, act).detach())
    if case == "grad_bf16":
        assert got.requires_grad
        with torch.no_grad():
            assert kba._records(y, p["b"]) is False


def test_a_cpu_forward_launches_nothing():
    cfg = dataclasses.replace(PRESETS["conformer_s"], linear_size=32,
                              num_blocks=2, input_size=8, batch_size=2,
                              seg_len=16, device="cpu")
    params = model_init(cfg, torch.Generator().manual_seed(0))
    before = kba.launches
    with torch.no_grad():
        lp = model_apply(cfg, params, torch.rand(2, 16, 8),
                         compute_dtype="bfloat16")
    assert kba.launches == before and bool(torch.isfinite(lp).all())


def _layout_case(name):
    y = torch.zeros(7, 3, 64)
    b = torch.zeros(64)
    return {
        "block_product": (y, b, "swish", True),
        "rows": (y.reshape(-1, 64), b, "none", True),
        "glu_16": (torch.zeros(5, 32), torch.zeros(32), "glu", True),
        "n_not_8": (y[..., :60].contiguous(), b[:60], "none", False),
        "glu_not_16": (torch.zeros(5, 24), torch.zeros(24), "glu", False),
        "strided": (y.transpose(0, 1), b, "none", False),
        "misaligned": (torch.zeros(7 * 64 + 1)[1:].view(7, 64), b, "none",
                       False),
        "bf16_y": (y.to(BF16), b, "none", False),
        "b_bf16": (y, b.to(BF16), "none", False),
        "b_shape": (y, b[:32], "none", False),
        "b_strided": (y, torch.zeros(128)[::2], "none", False),
        "unknown_act": (y, b, "relu", False),
    }[name]


@pytest.mark.parametrize("name", [
    "block_product", "rows", "glu_16", "n_not_8", "glu_not_16", "strided",
    "misaligned", "bf16_y", "b_bf16", "b_shape", "b_strided",
    "unknown_act"])
def test_the_shapes_and_layouts_the_kernel_takes(name):
    y, b, act, ok = _layout_case(name)
    assert (kba._takes(y, b, act) is None) == ok


def test_the_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        kba.bias_act(torch.zeros(4, 64), torch.zeros(64), "swish")


# --- on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _product(rows, n, seed, dev):
    """A float32 product at the scale of a block linear's, and a bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((rows, n), generator=gen, device=dev) * 3
    b = torch.randn((n,), generator=gen, device=dev) * 0.5
    return y, b


# (rows, n, act): parakeet_ctc_batch (T' 750, B 32), conformer_l_batch (T'
# 300, B 64), conformer_s's widths (d 144), ragged row counts
SHAPES = [
    (24000, 4096, "swish"), (24000, 2048, "glu"), (24000, 3072, "none"),
    (24000, 1024, "none"),
    (19200, 2048, "swish"), (19200, 1024, "glu"), (19200, 512, "none"),
    (1000, 576, "swish"), (1000, 288, "glu"), (1000, 144, "none"),
    (37, 144, "glu"), (1, 576, "swish"), (333, 4096, "swish"),
    (333, 3072, "none"), (65, 16, "glu"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,act", SHAPES)
def test_kernel_is_bit_equal_to_plain_on_the_card(dev, rows, n, act):
    y, b = _product(rows, n, rows + n, dev)
    before = kba.launches
    got = kba.bias_act(y.reshape(rows, 1, n) if rows % 2 else y, b, act)
    torch.cuda.synchronize()
    assert kba.launches == before + 1
    want = kba.bias_act_plain(y, b, act, BF16)
    assert got.is_contiguous()
    assert _bits_equal(got.reshape(want.shape), want)


def _all_bf16(dev):
    """Every bf16 value but the NaNs, as float32 [65536 - NaNs]."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    v = bits.to(torch.int16).view(BF16)
    return v[~torch.isnan(v)].float()


def _same_or_both_nan(a, b):
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return torch.equal(na, nb) and _bits_equal(
        torch.where(na, torch.zeros_like(a), a),
        torch.where(nb, torch.zeros_like(b), b))


@pytest.mark.cuda
def test_every_bf16_value_through_the_sigmoid(dev):
    # swish at b = 0 takes t = y; GLU with a = 1 returns s(t) itself
    t = _all_bf16(dev)
    t = torch.cat([t, t.new_zeros(-t.numel() % 8)])
    z = torch.zeros(8, device=dev)
    y = t.reshape(-1, 8)
    got = kba.bias_act(y, z, "swish")
    want = kba.bias_act_plain(y, z, "swish", BF16)
    assert _same_or_both_nan(got, want)
    y2 = torch.cat([torch.ones_like(y), y], dim=1)
    z2 = torch.zeros(16, device=dev)
    got = kba.bias_act(y2, z2, "glu")
    want = kba.bias_act_plain(y2, z2, "glu", BF16)
    assert _same_or_both_nan(got, want)


def _card_model(dev, preset, blocks):
    if preset == "parakeet_ctc_1.1b":
        cfg = Config(model=preset, input_size=80, n_context=0,
                     linear_size=1024, rnn_hidden_size=1024,
                     vocab_size=1024, blank_id=1024, num_blocks=blocks,
                     compute_dtype="bfloat16", mesh_shape={})
    else:
        cfg = dataclasses.replace(PRESETS[preset], num_blocks=blocks,
                                  mesh_shape={})
    params = model_init(cfg, torch.Generator().manual_seed(5))
    x = torch.rand(3, 96, 80, generator=torch.Generator().manual_seed(6))
    return cfg, params, x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("preset,per_block", [("conformer_l", 6),
                                              ("parakeet_ctc_1.1b", 7)])
def test_model_forward_launches_and_equals_plain(dev, monkeypatch, preset,
                                                 per_block):
    cfg, params, x = _card_model(dev, preset, 2)
    with torch.no_grad():
        before = kba.launches
        got = model_apply(cfg, params, x, compute_dtype="bfloat16")
        torch.cuda.synchronize()
        assert kba.launches - before == per_block * 2 + 1
        monkeypatch.setattr(kba, "bias_act_eligible", lambda *a: False)
        want = model_apply(cfg, params, x, compute_dtype="bfloat16")
        assert kba.launches - before == per_block * 2 + 1
        monkeypatch.undo()
        before = kba.launches
        model_apply(cfg, params, x)                 # float32: the plain path
        assert kba.launches == before
    assert torch.equal(got, want)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for v in items for t in _tensors(v)]


@pytest.mark.cuda
def test_a_forward_under_autograd_launches_nothing(dev):
    # every parameter requires grad, as in a training step
    cfg, params, x = _card_model(dev, "conformer_l", 1)
    leaves = [t for t in _tensors(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    before = kba.launches
    lp = model_apply(cfg, params, x, compute_dtype="bfloat16")
    lp.sum().backward()
    torch.cuda.synchronize()
    assert kba.launches == before
    assert all(t.grad is not None for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["misaligned", "strided", "odd_width",
                                  "under_autograd"])
def test_the_wrapper_refuses_on_the_card(dev, case):
    y, b = _product(64, 128, 8, dev)
    if case == "misaligned":
        flat = torch.zeros(64 * 128 + 1, device=dev)
        with pytest.raises(ValueError, match="aligned"):
            kba.bias_act(flat[1:].view(64, 128), b, "none")
    elif case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            kba.bias_act(y.t(), b[:64], "none")
    elif case == "odd_width":
        with pytest.raises(ValueError, match="multiple of 16"):
            kba.bias_act(y[:, :120].contiguous(), b[:120], "glu")
    else:
        with pytest.raises(NotImplementedError, match="forward only"):
            kba.bias_act(y, b.requires_grad_(True), "swish")
