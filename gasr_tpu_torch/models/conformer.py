"""Conformer-CTC (BASELINE.json configs 4-5): the port of
`gasr_tpu/models/conformer.py`, forward only.

Conv subsampling (4x in time and freq) -> N Conformer blocks (half-step
FFN -> rel-pos MHSA -> conv module -> half-step FFN -> LayerNorm) ->
projection -> log_softmax. Time-major [T, B, D]; LayerNorm everywhere,
including the conv module (the JAX package's documented deviation from
the paper's BatchNorm).

The port adds one preset, "parakeet_ctc_1.1b": NVIDIA NeMo's
FastConformer-XXL with a CTC head (Rekesh et al. 2023, arXiv:2305.05084).
Its block is the one above; five features differ, each a property of the
preset (`_FEATURES` gives every other preset the Conformer's):
  - stem "dw_striding": 8x in time and freq: conv 3x3 stride 2 (1 -> C
    channels), ReLU, then twice [depthwise 3x3 stride 2, pointwise 1x1
    C -> C, ReLU], every conv padded (1, 1) as NeMo's; the [T/8, F/8 * C]
    frames (freq-major) through a linear to d;
  - xscaling: the stem's output times sqrt(d);
  - attn_bias: biases on the q, k, v and output projections (none on
    the position projection);
  - conv_norm "batch": an inference-mode BatchNorm (running mean and
    variance, gain and bias, eps 1e-5) after the depthwise conv in place
    of its LayerNorm, applied in float32 as one per-channel affine with
    the depthwise bias folded in.
The output width is the config's vocab + 1, blank wherever `blank_id`
puts it (last for this preset's configurations).

compute_dtype (bf16) is the JAX package's mixed-precision policy: params
stay float32, every product and convolution takes bf16 operands with
float32 sums, the residual stream is carried at bf16, and the LayerNorm
statistics, the attention softmax and the final log_softmax stay
float32. The rounding points are the JAX package's; `ops/linear.py` and
`ops/conv.py` say where a device adds one.

attn_impl ("xla" | "pallas" | "auto") picks the attention route
(`ops/attention.py`); stem_impl="pallas" takes the fused stem kernel
(`ops/cuda/stem.py`) where `stem_eligible` holds, and "auto" never does
(the JAX package keeps it opt-in: it lost to XLA's stem on the TPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.ops.attention import mhsa_rel, mhsa_rel_init
from gasr_tpu_torch.ops.conv import conv2d, conv2d_init, conv_mixed
from gasr_tpu_torch.ops.cuda.stem import fused_stem, stem_eligible
from gasr_tpu_torch.ops.linear import linear, linear_init, normal_init
from gasr_tpu_torch.runtime.profiler import span

_PRESETS = {
    "conformer_s": dict(d_model=144, num_blocks=16, num_heads=4,
                        ff_mult=4, conv_kernel=31),
    "conformer_l": dict(d_model=512, num_blocks=17, num_heads=8,
                        ff_mult=4, conv_kernel=31),
    "parakeet_ctc_1.1b": dict(d_model=1024, num_blocks=42, num_heads=8,
                              ff_mult=4, conv_kernel=9, stem="dw_striding",
                              stem_channels=256, xscaling=True,
                              attn_bias=True, conv_norm="batch"),
}

# the Conformer's block, where a preset states nothing else
_FEATURES = dict(stem="conv", stem_channels=None, xscaling=False,
                 attn_bias=False, conv_norm="layer")

_BN_EPS = 1e-5


def _preset(config: Config) -> dict:
    p = dict(_FEATURES,
             **_PRESETS.get(config.model, _PRESETS["conformer_s"]))
    # config overrides of width and depth, as in the JAX package
    if config.linear_size and config.linear_size != p["d_model"]:
        p["d_model"] = config.linear_size
    if config.num_blocks is not None:
        p["num_blocks"] = config.num_blocks
    return p


def _dtype(compute_dtype) -> Optional[torch.dtype]:
    """None, a torch dtype, or a config string ("float32" means None)."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return None if compute_dtype == "float32" else getattr(torch,
                                                           compute_dtype)


def _ln_init(d: int, device) -> dict:
    return {"g": torch.ones((d,), device=device),
            "b": torch.zeros((d,), device=device)}


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics; the output keeps x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]
    return y.to(x.dtype)


def _ffn_init(generator, d: int, mult: int, device) -> dict:
    return {"ln": _ln_init(d, device),
            "w1": linear_init(generator, d, d * mult, device),
            "w2": linear_init(generator, d * mult, d, device)}


def _lin(p: dict, x: torch.Tensor, cd) -> torch.Tensor:
    """linear() at the block compute dtype, re-emitted at that dtype."""
    y = linear(p, x, None, cd)
    return y if cd is None else y.to(cd)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid's expression, 1 / (1 + exp(-x)), each step rounded
    to x's dtype (torch.sigmoid rounds once from float32, which differs
    in about a third of bf16 outputs)."""
    return 1.0 / (1.0 + torch.exp(-x))


def _ffn(p: dict, x: torch.Tensor, cd=None) -> torch.Tensor:
    h = _ln(p["ln"], x)
    h = _lin(p["w1"], h, cd)
    h = h * _sigmoid(h)                           # swish
    return _lin(p["w2"], h, cd)


def _convmod_init(generator, d: int, kernel: int, device,
                  norm: str = "layer") -> dict:
    p = {
        "ln": _ln_init(d, device),
        "pw1": linear_init(generator, d, 2 * d, device),
        "dw": normal_init(generator, (kernel, 1, d), 1.0 / (d ** 0.5),
                          device),                # [K, 1, D] WIO
        "dw_b": torch.zeros((d,), device=device),
    }
    if norm == "batch":
        # running statistics of a fresh BatchNorm1d, gain 1 and bias 0
        p["bn"] = {"mean": torch.zeros((d,), device=device),
                   "var": torch.ones((d,), device=device),
                   **_ln_init(d, device)}
    else:
        p["ln2"] = _ln_init(d, device)
    p["pw2"] = linear_init(generator, d, d, device)
    return p


def _bn_affine(bn: dict, bias: torch.Tensor) -> tuple:
    """Inference BatchNorm after a conv with `bias`, as one per-channel
    affine of the conv's sums: (scale, shift) with
    bn(y + bias) = y * scale + shift."""
    scale = bn["g"] * torch.rsqrt(bn["var"] + _BN_EPS)
    return scale, (bias - bn["mean"]) * scale + bn["b"]


def _convmod(p: dict, x: torch.Tensor, kernel: int, cd=None) -> torch.Tensor:
    """Conformer conv module. x: [T, B, D]."""
    h = _ln(p["ln"], x)
    h = _lin(p["pw1"], h, cd)                     # [T, B, 2D]
    a, b = h.chunk(2, dim=-1)
    h = a * _sigmoid(b)                           # GLU
    hw = h.transpose(0, 1)                        # [B, T, D] (NWC)
    D = hw.shape[-1]
    dw = p["dw"] if cd is None else p["dw"].to(cd)
    # depthwise over time, lax "SAME": pads (K-1)//2 and K//2
    hw = conv_mixed(hw, dw, (1,), "SAME", groups=D)
    if "bn" in p:                                 # float32 BatchNorm
        scale, shift = _bn_affine(p["bn"], p["dw_b"])
        hw = torch.addcmul(shift, hw, scale)
    else:
        hw = hw + p["dw_b"]
    if cd is not None:
        hw = hw.to(cd)
    h = hw.transpose(0, 1)
    if "ln2" in p:
        h = _ln(p["ln2"], h)
    h = h * _sigmoid(h)                           # swish
    return _lin(p["pw2"], h, cd)


def _block_init(generator, d: int, heads: int, ff_mult: int, kernel: int,
                device, attn_bias: bool = False,
                conv_norm: str = "layer") -> dict:
    p = {
        "ff1": _ffn_init(generator, d, ff_mult, device),
        "mhsa_ln": _ln_init(d, device),
        "mhsa": mhsa_rel_init(generator, d, heads, device),
        "conv": _convmod_init(generator, d, kernel, device, conv_norm),
        "ff2": _ffn_init(generator, d, ff_mult, device),
        "ln_out": _ln_init(d, device),
    }
    if attn_bias:
        p["mhsa"].update({b: torch.zeros((d,), device=device)
                          for b in ("bq", "bk", "bv", "bo")})
    return p


def _block(p: dict, x: torch.Tensor, heads: int, kernel: int, mask=None,
           cd=None, attn_impl: str = "auto") -> torch.Tensor:
    x = x + 0.5 * _ffn(p["ff1"], x, cd)
    a = mhsa_rel(p["mhsa"], _ln(p["mhsa_ln"], x), heads, mask,
                 compute_dtype=cd, impl=attn_impl)
    x = x + (a if cd is None else a.to(cd))
    x = x + _convmod(p["conv"], x, kernel, cd)
    x = x + 0.5 * _ffn(p["ff2"], x, cd)
    return _ln(p["ln_out"], x)


def conformer_output_length(input_length):
    """4x time subsampling (two stride-2 convs, SAME padding)."""
    return -(-(-(-input_length // 2)) // 2)


def _subsampled(n, hp: dict):
    """n frames (or mels) after the preset's stem: 4x, or 8x for
    "dw_striding" (three stride-2 convs padded (1, 1): ceil(n / 2)
    each)."""
    n = conformer_output_length(n)
    return -(-n // 2) if hp["stem"] == "dw_striding" else n


def _dw_striding_init(generator, C: int, d: int, f_sub: int, device,
                      dtype) -> dict:
    """NeMo's "dw_striding" stem: sub1 conv 1 -> C; sub2 and sub3 each a
    depthwise 3x3 ("*_dw", HWIO [3, 3, 1, C]) and a pointwise 1x1
    ("*_pw", [1, 1, C, C]); sub_proj rows freq-major."""
    p = {"sub1": conv2d_init(generator, 1, C, (3, 3), device, dtype)}
    for i in (2, 3):
        p[f"sub{i}_dw"] = conv2d_init(generator, 1, C, (3, 3), device,
                                      dtype)
        p[f"sub{i}_pw"] = conv2d_init(generator, C, C, (1, 1), device,
                                      dtype)
    p["sub_proj"] = linear_init(generator, C * f_sub, d, device, dtype)
    return p


def _conv_relu(p: dict, x: torch.Tensor, stride, pad: int, groups: int,
               cd, relu: bool = True) -> torch.Tensor:
    """x [B, H, W, C] NHWC -> conv (padded (pad, pad)), bias in float32,
    ReLU where `relu`, emitted at cd (float32 without one)."""
    w = p["w"] if cd is None else p["w"].to(cd)
    x = x if cd is None else x.to(cd)
    y = conv_mixed(x, w, stride, [(pad, pad), (pad, pad)], groups) \
        + p["b"].float()
    if relu:
        y = y.relu_()
    return y if cd is None else y.to(cd)


def _dw_striding(params: dict, x: torch.Tensor, cd) -> torch.Tensor:
    """x [B, T, F] -> [B, T/8, F/8 * C] (freq-major)."""
    C = params["sub1"]["w"].shape[-1]
    h = _conv_relu(params["sub1"], x[..., None], (2, 2), 1, 1, cd)
    for i in (2, 3):
        h = _conv_relu(params[f"sub{i}_dw"], h, (2, 2), 1, C, cd,
                       relu=False)
        h = _conv_relu(params[f"sub{i}_pw"], h, (1, 1), 0, 1, cd)
    B, Tp, Fp, _ = h.shape
    return h.reshape(B, Tp, Fp * C)


def conformer_init(generator: torch.Generator, config: Config,
                   device="cpu", dtype=torch.float32) -> dict:
    """Params with the JAX package's names and layouts (conv weights HWIO,
    `dw` [K, 1, D], `sub_proj` rows freq-major), drawn from `generator`;
    the stem and the output projection in `dtype`, the blocks in float32
    (JAX's `conformer_init` passes its dtype to those four alone)."""
    hp = _preset(config)
    d = hp["d_model"]
    # freq is subsampled as time is
    f_sub = _subsampled(config.feat_size, hp)
    if hp["stem"] == "dw_striding":
        p = _dw_striding_init(generator, hp["stem_channels"], d, f_sub,
                              device, dtype)
    else:
        p = {"sub1": conv2d_init(generator, 1, d, (3, 3), device, dtype),
             "sub2": conv2d_init(generator, d, d, (3, 3), device, dtype),
             "sub_proj": linear_init(generator, d * f_sub, d, device,
                                     dtype)}
    p["blocks"] = [
        _block_init(generator, d, hp["num_heads"], hp["ff_mult"],
                    hp["conv_kernel"], device, hp["attn_bias"],
                    hp["conv_norm"])
        for _ in range(hp["num_blocks"])]
    p["proj"] = linear_init(generator, d, config.output_size, device, dtype)
    return p


def conformer_apply(config: Config, params: dict, x: torch.Tensor,
                    mask=None, compute_dtype=None, attn_impl: str = "auto",
                    stem_impl: str = "auto", **_) -> torch.Tensor:
    """x: [B, T, F] -> log-probs [T', B, vocab+1] float32: T' =
    ceil(T/4), or ceil(T/8) for a "dw_striding" stem. Span: "model.stem"
    around the stem."""
    hp = _preset(config)
    cd = _dtype(compute_dtype)
    d, heads, kernel = hp["d_model"], hp["num_heads"], hp["conv_kernel"]
    B, T, Fr = x.shape
    if stem_impl not in ("xla", "pallas", "auto"):
        raise ValueError(f"unknown stem impl {stem_impl!r}")

    with span("model.stem"):
        if hp["stem"] == "dw_striding":
            h = _lin(params["sub_proj"], _dw_striding(params, x, cd), cd)
        elif stem_impl == "pallas" and stem_eligible(T, Fr, d, d):
            h = fused_stem(x, params["sub1"]["w"], params["sub1"]["b"],
                           params["sub2"]["w"], params["sub2"]["b"],
                           params["sub_proj"]["w"], params["sub_proj"]["b"],
                           out_dtype=cd if cd is not None else torch.float32)
        else:
            h = x[..., None]                      # [B, T, F, 1]
            h = conv2d(params["sub1"], h, (2, 2), compute_dtype=cd)
            h = conv2d(params["sub2"], h, (2, 2), compute_dtype=cd)
            _, Tp, Fp, C = h.shape                # [B, T/4, F/4, d]
            h = h.reshape(B, Tp, Fp * C)          # freq-major: f * d + c
            h = _lin(params["sub_proj"], h, cd)
        if hp["xscaling"]:
            h = h * d ** 0.5
    h = h.transpose(0, 1)                         # [T', B, d]
    for blk in params["blocks"]:
        h = _block(blk, h, heads, kernel, mask, cd, attn_impl)
    logits = linear(params["proj"], h, None, cd)
    return torch.log_softmax(logits, dim=-1)
