"""Plain FastConformer-CTC forward (Rekesh et al. 2023, arXiv:2305.05084;
NVIDIA NeMo's Parakeet-CTC-1.1B, FastConformer-XXL), as the
`parakeet_ctc_1.1b` configuration runs it, in float32.

    stem   : conv 3x3 stride 2 (1 -> C channels), ReLU; then twice
             [depthwise conv 3x3 stride 2 (groups C), pointwise conv 1x1
             C -> C, ReLU] over (time, mel); every conv padded 1 on each
             side (output floor((n - 1) / 2) + 1 = ceil(n / 2)), with a
             bias; then the [T/8, F/8 * C] frames (frequency-major)
             through a linear to d
    scale  : x = stem(x) * sqrt(d)                       (xscaling)
    block  : x += FFN(x) / 2;  x += MHSA(LN(x));  x += Conv(x);
             x += FFN(x) / 2;  x = LN(x)
    FFN    : LN, linear to 4d, swish, linear to d
    MHSA   : q, k, v = x W_q + b_q, x W_k + b_k, x W_v + b_v; relative
             attention: score(i, j) = ((q_i + u) . k_j + (q_i + v) .
             r_{i-j}) / sqrt(d_h), r_p the sinusoid of offset p through
             W_r (no bias); softmax over j; heads concatenated, then
             W_o + b_o; u and v per block (untied)
    Conv   : LN, linear to 2d, GLU, depthwise conv over time (kernel K,
             padded (K-1)/2 each side) + bias, BatchNorm with running
             statistics ((y - mean) / sqrt(var + 1e-5) * g + b), swish,
             linear to d
    head   : linear to V+1 (blank last), log_softmax

Departures from NeMo, as the configuration's file lists them: padded
frames are attended and convolved (no mask), the sinusoid basis is sines
then cosines (NeMo interleaves them: a fixed permutation of W_r's rows),
the stem's frames are frequency-major (NeMo's are channel-major: a fixed
permutation of the linear's rows), no dropout. Weights are the tensors
the benchmark made, in its layout: linears "w" [in, out]; convolutions
"w" [kh, kw, in / groups, out]; the depthwise kernel "dw" [K, 1, d];
attention "wq", "wk", "wv", "wo", "wr" [d, d], "bq", "bk", "bv", "bo"
[d] and "u", "v" [heads, d_h]; BatchNorm "bn" {"mean", "var", "g",
"b"} [d]. Input [B, T, F], output log-probs [T', B, V+1].

`precision` rounds every product's operands (`precision.round_to`).
The relative term is read from the [T, 2T-1] product of q + v with all
offsets by an index gather, offset T-1 first.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from asrbench.counts.fastconformer import (  # noqa: F401
    fastconformer as forward_flops)
from asrbench.reference import spec as S
from asrbench.reference.conformer import (_ffn, _lin, _ln, _same,
                                          _sinusoids, _swish)
from asrbench.reference.precision import mm, round_to

BN_EPS = 1e-5
VAR_HALF = 0.5               # running variances drawn from [0.5, 1.5]


def _halve(n: int) -> int:
    """A 3x3 stride-2 conv padded 1 on each side: floor((n - 1) / 2) + 1."""
    return (n - 1) // 2 + 1


def output_frames(frames: int) -> int:
    """The stem halves time three times."""
    return _halve(_halve(_halve(frames)))


def _conv(out: S.Spec, path: tuple, kh: int, kw: int, c_in: int,
          c_out: int) -> None:
    h = 1.0 / math.sqrt(kh * kw * c_in)
    out.append((path + ("w",), (kh, kw, c_in, c_out), 0.0, h))
    out.append((path + ("b",), (c_out,), 0.0, h))


def spec(m: Dict) -> S.Spec:
    d, heads, mult, K, C = (m["d_model"], m["num_heads"], m["ff_mult"],
                            m["conv_kernel"], m["stem_channels"])
    f_sub = output_frames(m["feat_size"])
    out: S.Spec = []
    _conv(out, ("sub1",), 3, 3, 1, C)
    for i in (2, 3):
        _conv(out, (f"sub{i}_dw",), 3, 3, 1, C)
        _conv(out, (f"sub{i}_pw",), 1, 1, C, C)
    S.lin(out, ("sub_proj",), C * f_sub, d)
    unit = math.sqrt(3.0 / d)            # uniform of variance 1 / d
    hb = 1.0 / math.sqrt(d)
    for i in range(m["num_blocks"]):
        b = ("blocks", i)
        S.ffn(out, b + ("ff1",), d, mult)
        S.ln(out, b + ("mhsa_ln",), d)
        for w in ("wq", "wk", "wv", "wo", "wr"):
            out.append((b + ("mhsa", w), (d, d), 0.0, unit))
        for w in ("u", "v"):
            out.append((b + ("mhsa", w), (heads, d // heads), 0.0,
                        S.BIAS_HALF))
        for w in ("bq", "bk", "bv", "bo"):
            out.append((b + ("mhsa", w), (d,), 0.0, hb))
        S.ln(out, b + ("conv", "ln"), d)
        S.lin(out, b + ("conv", "pw1"), d, 2 * d)
        out.append((b + ("conv", "dw"), (K, 1, d), 0.0, unit))
        out.append((b + ("conv", "dw_b"), (d,), 0.0, S.BIAS_HALF))
        out.append((b + ("conv", "bn", "mean"), (d,), 0.0, S.BIAS_HALF))
        out.append((b + ("conv", "bn", "var"), (d,), 1.0, VAR_HALF))
        S.ln(out, b + ("conv", "bn"), d)
        S.lin(out, b + ("conv", "pw2"), d, d)
        S.ffn(out, b + ("ff2",), d, mult)
        S.ln(out, b + ("ln_out",), d)
    S.lin(out, ("proj",), d, m["vocab_size"] + 1)
    return out


def _stem_conv(p: dict, x: torch.Tensor, stride: int, pad: int,
               groups: int, prec: str, relu: bool) -> torch.Tensor:
    """x [B, C, T, F] -> the conv (padded `pad` on each side) + bias."""
    w = p["w"].permute(3, 2, 0, 1)                  # [out, in/groups, kh, kw]
    y = F.conv2d(round_to(F.pad(x, (pad, pad, pad, pad)), prec),
                 round_to(w, prec), stride=stride, groups=groups)
    y = y + p["b"][None, :, None, None]
    return torch.relu(y) if relu else y


def _stem(params: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """x [B, T, F] -> [B, T', F' * C] (frequency-major: f * C + c)."""
    C = params["sub1"]["w"].shape[-1]
    h = _stem_conv(params["sub1"], x[:, None], 2, 1, 1, prec, True)
    for i in (2, 3):
        h = _stem_conv(params[f"sub{i}_dw"], h, 2, 1, C, prec, False)
        h = _stem_conv(params[f"sub{i}_pw"], h, 1, 0, 1, prec, True)
    B, _, Tp, Fp = h.shape
    return h.permute(0, 2, 3, 1).reshape(B, Tp, Fp * C)


def _mhsa(p: dict, x: torch.Tensor, heads: int, prec: str) -> torch.Tensor:
    """x [T, B, d] -> [T, B, d]."""
    T, B, d = x.shape
    dh = d // heads

    def split(y):                                       # -> [B, H, T, dh]
        return y.reshape(T, B, heads, dh).permute(1, 2, 0, 3)

    q, k, v = (split(mm(x, p["w" + n], prec) + p["b" + n])
               for n in ("q", "k", "v"))
    r = mm(_sinusoids(T, d, x.device), p["wr"], prec)    # [2T-1, d]
    r = r.reshape(2 * T - 1, heads, dh).permute(1, 2, 0)  # [H, dh, 2T-1]
    ac = mm(q + p["u"][None, :, None, :], k.transpose(-1, -2), prec)
    bd_all = mm(q + p["v"][None, :, None, :], r[None], prec)  # [B,H,T,2T-1]
    i = torch.arange(T, device=x.device)
    col = (T - 1) - (i[:, None] - i[None, :])           # offset i - j
    bd = bd_all.gather(-1, col[None, None].expand(B, heads, T, T))
    attn = torch.softmax((ac + bd) / math.sqrt(dh), dim=-1)
    out = mm(attn, v, prec)                             # [B, H, T, dh]
    out = out.permute(2, 0, 1, 3).reshape(T, B, d)
    return mm(out, p["wo"], prec) + p["bo"]


def _batch_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (x - p["mean"]) / torch.sqrt(p["var"] + BN_EPS) * p["g"] + p["b"]


def _conv_module(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    h = _lin(p["pw1"], _ln(p["ln"], x), prec)          # [T, B, 2d]
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)
    K, _, d = p["dw"].shape
    lo, hi = _same(h.shape[0], K, 1)
    hc = F.pad(h.permute(1, 2, 0), (lo, hi))            # [B, d, T + K - 1]
    w = p["dw"].permute(2, 1, 0)                        # [d, 1, K]
    h = F.conv1d(round_to(hc, prec), round_to(w, prec), groups=d)
    h = _batch_norm(p["bn"], h.permute(2, 0, 1) + p["dw_b"])
    return _lin(p["pw2"], _swish(h), prec)


def forward(params: dict, x: torch.Tensor, heads: int,
            precision: str = "f32") -> torch.Tensor:
    """x [B, T, F] -> log-probs [output_frames(T), B, V+1]."""
    h = _lin(params["sub_proj"], _stem(params, x, precision), precision)
    d = h.shape[-1]
    h = (h * math.sqrt(d)).transpose(0, 1)              # [T', B, d]
    for blk in params["blocks"]:
        h = h + 0.5 * _ffn(blk["ff1"], h, precision)
        h = h + _mhsa(blk["mhsa"], _ln(blk["mhsa_ln"], h), heads, precision)
        h = h + _conv_module(blk["conv"], h, precision)
        h = h + 0.5 * _ffn(blk["ff2"], h, precision)
        h = _ln(blk["ln_out"], h)
    return torch.log_softmax(_lin(params["proj"], h, precision), dim=-1)


def apply(params: dict, x: torch.Tensor, model: Dict,
          precision: str) -> torch.Tensor:
    return forward(params, x, model["num_heads"], precision)
