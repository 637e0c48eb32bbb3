"""The conformer block's residual add and LayerNorm (`ops/cuda/add_ln.py`,
`csrc/add_ln.cu`).

On the CPU:
  - `add_ln_plain` bit-equal to the block's eager expressions (the
    residual add, then the LayerNorm), in bf16 and float32, for the
    three residual forms (`x + 0.5 * ffn`, `x + a.to(x.dtype)` with a
    float32, `x + convmod`) and with no add;
  - the kernel's arithmetic, emulated lane by lane (8 elements a chunk,
    chunks lane, lane + 32, ..., each lane's sum in order, then the
    shuffle butterfly, two passes over the row), against `add_ln_plain`:
    x' bit-equal, h off on at most H_SHARE of elements, by at most one
    bf16 step at the scale of the norm's last add;
  - the dispatch: CPU tensors, float32 and inputs under autograd take the
    plain path, and the shapes and layouts the wrapper refuses.
Marked `cuda` (every such test skips without a card): the kernel against
`add_ln_plain` on the card; a bf16 forward of conformer_l and
parakeet_ctc_1.1b cut to two blocks counts 6 and 5 launches a block and
stays within the benchmark cells' log-prob limits of the plain path; a
forward under autograd and a float32 one count none; the refusals.

This file imports no JAX, so on a machine without JAX its card tests run
as
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_add_ln.py
"""

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from gasr_tpu_torch.config import PRESETS, Config
from gasr_tpu_torch.models import conformer as tconf
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.ops.cuda import add_ln as kadd
from chip_smoke import ADD_LN_H_SHARE as H_SHARE, add_ln_h_steps

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def _todays_ln(p, x):
    # the block's LayerNorm as the model wrote it before the kernel
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]
    return y.to(x.dtype)


def _inputs(d, dtype, seed, T=7, B=3, device="cpu"):
    """x as the block sees it (the transposed view of [B, T, d]), a branch
    output in x's dtype and one in float32, and a norm's g and b."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, T, d, generator=gen) * 2 + 0.5).to(dtype)
    x = x.to(device).transpose(0, 1)
    y = torch.randn(T, B, d, generator=gen).to(dtype).to(device)
    y32 = torch.randn(T, B, d, generator=gen).to(device)
    p = {"g": (1 + 0.1 * torch.randn(d, generator=gen)).to(device),
         "b": (0.1 * torch.randn(d, generator=gen)).to(device)}
    return x, y, y32, p


def _h_within(h, want_x, p, want_h):
    # the kernel's float32 sums run in another order than PyTorch's
    # reduction, so mu or var may differ in the last float32 bit, which
    # moves h across a bf16 rounding boundary now and then: by at most one
    # step at the scale of the norm's last add, on at most H_SHARE of
    # elements (chip_smoke.py's bound for the same comparison)
    steps = add_ln_h_steps(h, want_x, p["g"], p["b"], want_h)
    return float(steps.max()) <= 1 and \
        float((steps > 0).float().mean()) <= H_SHARE


def _bits_equal(a, b):
    if a.dtype != b.dtype:
        return False
    if a.dtype == BF16:
        a, b = (t.contiguous().view(torch.int16) for t in (a, b))
    return torch.equal(a, b)


# (form, s, y): the block's three residual forms and the bare norm
FORMS = {"ffn": (0.5, "same"), "attention": (1.0, "f32"),
         "conv": (1.0, "same"), "none": (1.0, None)}


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_is_the_blocks_expressions(dtype, form):
    x, y, y32, p = _inputs(64, dtype, 1)
    s, yk = FORMS[form]
    if form == "ffn":
        want_x = x + 0.5 * y
    elif form == "attention":
        # x + (a if cd is None else a.to(cd)), x at cd
        want_x = x + (y32 if dtype == torch.float32 else y32.to(dtype))
    elif form == "conv":
        want_x = x + y
    else:
        want_x = x
    got_x, got_h = kadd.add_ln_plain(
        x, {"same": y, "f32": y32, None: None}[yk], s, p["g"], p["b"])
    assert _bits_equal(got_x, want_x)
    assert _bits_equal(got_h, _todays_ln(p, want_x))


def emulate_add_ln(x, y, s, g, b):
    """`csrc/add_ln.cu`'s arithmetic on the CPU in float32: returns (x', h)
    as [rows, d] bf16."""
    d = x.shape[-1]
    xv = x.reshape(-1, d).float()
    if y is not None:
        t = y.reshape(-1, d).to(BF16).float()
        t = (s * t).to(BF16).float()
        xv = (xv + t).to(BF16).float()
    chunks = d // 8
    nv = -(-chunks // 32)

    def row_sum(v):
        acc = torch.zeros(v.shape[0], 32)
        for k in range(nv):
            lanes = [ln for ln in range(32) if ln + 32 * k < chunks]
            for q in range(8):
                cols = [(ln + 32 * k) * 8 + q for ln in lanes]
                acc[:, :len(lanes)] = acc[:, :len(lanes)] + v[:, cols]
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, [ln ^ o for ln in range(32)]]
        assert torch.equal(acc, acc[:, :1].expand_as(acc))
        return acc[:, :1]

    inv_d = torch.tensor(1.0) / d
    mu = row_sum(xv) * inv_d
    e = xv - mu
    var = row_sum(e * e) * inv_d
    h = (xv - mu) * torch.rsqrt(var + 1e-5) * g + b
    return xv.to(BF16), h.to(BF16)


@pytest.mark.parametrize("d", [144, 512, 1000, 1024])
@pytest.mark.parametrize("yk,s", [(None, 1.0), ("same", 0.5), ("f32", 1.0),
                                  ("f32", 0.5)])
def test_the_kernels_arithmetic_against_plain(d, yk, s):
    x, y, y32, p = _inputs(d, BF16, d + len(str(yk)), T=9, B=5)
    yy = {"same": y, "f32": y32, None: None}[yk]
    want_x, want_h = kadd.add_ln_plain(x, yy, s, p["g"], p["b"])
    got_x, got_h = emulate_add_ln(x, yy, s, p["g"], p["b"])
    assert _bits_equal(got_x, want_x.reshape(-1, d))
    assert _h_within(got_h, want_x.reshape(-1, d), p, want_h.reshape(-1, d))


@pytest.mark.parametrize("case", ["cpu_bf16", "cpu_f32", "grad_bf16"])
def test_the_rule_takes_the_plain_path(case):
    dtype = torch.float32 if case == "cpu_f32" else BF16
    x, y, _, p = _inputs(64, dtype, 2)
    if case == "grad_bf16":
        p = {k: v.requires_grad_(True) for k, v in p.items()}
    assert not kadd.add_ln_eligible(x, y, p["g"], p["b"])
    before = kadd.launches
    got = tconf._add_ln(p, x, y, 0.5)
    want = kadd.add_ln_plain(x, y, 0.5, p["g"], p["b"])
    assert kadd.launches == before
    assert all(_bits_equal(a.detach(), w.detach())
               for a, w in zip(got, want))
    if case == "grad_bf16":
        assert got[1].requires_grad
        with torch.no_grad():
            assert kadd._records(x, y, p["g"], p["b"]) is False


def test_a_cpu_forward_launches_nothing():
    cfg = dataclasses.replace(PRESETS["conformer_s"], linear_size=32,
                              num_blocks=2, input_size=8, batch_size=2,
                              seg_len=16, device="cpu")
    params = model_init(cfg, torch.Generator().manual_seed(0))
    before = kadd.launches
    with torch.no_grad():
        lp = model_apply(cfg, params, torch.rand(2, 16, 8),
                         compute_dtype="bfloat16")
    assert kadd.launches == before and bool(torch.isfinite(lp).all())


def _layout_case(name):
    x, y, y32, p = _inputs(512, BF16, 3)
    g, b = p["g"], p["b"]
    wide = torch.zeros(7, 3, 520, dtype=BF16)
    return {
        "block_view": (x, y32, g, b, True),
        "bf16_y": (x, y, g, b, True),
        "rows": (x.reshape(-1, 512), None, g, b, True),
        "d_not_8": (x[..., :12], None, g[:12], b[:12], False),
        "d_past_1024": (torch.zeros(2, 1032, dtype=BF16), None,
                        torch.ones(1032), torch.zeros(1032), False),
        "four_dims": (x[None], None, g, b, False),
        "d_strided": (torch.zeros(7, 3, 16, dtype=BF16)[..., ::2], None,
                      g[:8], b[:8], False),
        "y_misaligned": (x, wide[..., 1:513], g, b, False),
        "y_shape": (x, y[:1], g, b, False),
        "y_float16": (x, y.half(), g, b, False),
        "g_bf16": (x, y, g.to(BF16), b, False),
        "b_shape": (x, y, g, b[:256], False),
    }[name]


@pytest.mark.parametrize("name", [
    "block_view", "bf16_y", "rows", "d_not_8", "d_past_1024", "four_dims",
    "d_strided", "y_misaligned", "y_shape", "y_float16", "g_bf16",
    "b_shape"])
def test_the_shapes_and_layouts_the_wrapper_takes(name):
    x, y, g, b, ok = _layout_case(name)
    assert (kadd._takes(x, y, g, b) is None) == ok


def test_the_wrapper_refuses_a_cpu_tensor():
    x, y, _, p = _inputs(64, BF16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kadd.add_ln(x, y, 0.5, p["g"], p["b"])


# --- on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [144, 512, 1024])
@pytest.mark.parametrize("yk,s", [(None, 1.0), ("same", 0.5), ("same", 1.0),
                                  ("f32", 1.0), ("f32", 0.5)])
@pytest.mark.parametrize("keep", [True, False])
def test_kernel_against_plain_on_the_card(dev, d, yk, s, keep):
    # 37 x 3 rows: not a multiple of a block's 8
    x, y, y32, p = _inputs(d, BF16, d + 7, T=37, B=3, device=dev)
    yy = {"same": y, "f32": y32, None: None}[yk]
    before = kadd.launches
    got_x, got_h = kadd.add_ln(x, yy, s, p["g"], p["b"], keep)
    torch.cuda.synchronize()
    assert kadd.launches == before + 1
    want_x, want_h = kadd.add_ln_plain(x, yy, s, p["g"], p["b"])
    if yy is None:
        assert got_x is x
    elif keep:
        assert got_x.is_contiguous() and _bits_equal(got_x, want_x)
    else:
        assert got_x is None
    assert got_h.is_contiguous() and got_h.shape == x.shape
    assert _h_within(got_h, want_x, p, want_h)


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


def _limits(cell):
    return json.loads((ROOT / "asrbench" / "limits" /
                       f"{cell}.json").read_text())["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("preset,cell,per_block", [
    ("conformer_l", "conformer_l_batch", 6),
    ("parakeet_ctc_1.1b", "parakeet_ctc_batch", 5)])
def test_model_forward_launches_and_stays_near_plain(dev, monkeypatch,
                                                     preset, cell,
                                                     per_block):
    cfg, params, x = _card_model(dev, preset, 2)
    with torch.no_grad():
        before = kadd.launches
        got = model_apply(cfg, params, x, compute_dtype="bfloat16")
        torch.cuda.synchronize()
        assert kadd.launches - before == per_block * 2
        monkeypatch.setattr(tconf, "add_ln_eligible", lambda *a: False)
        want = model_apply(cfg, params, x, compute_dtype="bfloat16")
        assert kadd.launches - before == per_block * 2
        monkeypatch.undo()
        before = kadd.launches
        model_apply(cfg, params, x)                 # float32: the plain path
        assert kadd.launches == before
    lim = _limits(cell)
    diff = (got - want).float()
    rms = math.sqrt(float((diff ** 2).mean()))
    assert rms <= lim["lp_rms"]
    assert float(diff[0].abs().max()) <= lim["lp_gap_t0"]


@pytest.mark.cuda
def test_a_forward_under_autograd_launches_nothing(dev):
    cfg, params, x = _card_model(dev, "conformer_l", 1)
    leaves = [params["blocks"][0]["mhsa_ln"]["g"],
              params["blocks"][0]["ff1"]["ln"]["b"]]
    for t in leaves:
        t.requires_grad_(True)
    before = kadd.launches
    lp = model_apply(cfg, params, x, compute_dtype="bfloat16")
    lp.sum().backward()
    torch.cuda.synchronize()
    assert kadd.launches == before
    assert all(t.grad is not None for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float16", "d_not_8", "under_autograd"])
def test_the_wrapper_refuses_on_the_card(dev, case):
    x, y, _, p = _inputs(64, BF16, 8, device=dev)
    if case == "float16":
        with pytest.raises(ValueError, match="bf16"):
            kadd.add_ln(x.half(), None, 1.0, p["g"], p["b"])
    elif case == "d_not_8":
        with pytest.raises(ValueError, match="multiple of 8"):
            kadd.add_ln(x[..., :60], None, 1.0, p["g"][:60], p["b"][:60])
    else:
        with pytest.raises(NotImplementedError, match="forward only"):
            kadd.add_ln(x, y, 0.5, p["g"].requires_grad_(True), p["b"])
