"""Plain Conformer-CTC forward (Gulati et al. 2020, arXiv:2005.08100), as
the `conformer_l` configuration runs it, in float32.

    stem   : two 3x3 stride-2 convolutions over (time, mel), each
             followed by min(max(y, 0), 20); "SAME" padding (output
             ceil(n / 2), the odd pad after); then the [T/4, F/4 * d]
             frames (frequency-major) through a linear to d
    block  : x += FFN(x) / 2;  x += MHSA(LN(x));  x += Conv(x);
             x += FFN(x) / 2;  x = LN(x)
    FFN    : LN, linear to 4d, swish, linear to d
    MHSA   : Transformer-XL relative attention: score(i, j) =
             ((q_i + u) . k_j + (q_i + v) . r_{i-j}) / sqrt(d_h), r_p the
             sinusoid of offset p through W_r; softmax over j; heads
             concatenated through W_o; no projection biases
    Conv   : LN, linear to 2d, GLU, depthwise conv over time (kernel K,
             "SAME"), + bias, LN (in place of the paper's BatchNorm),
             swish, linear to d
    head   : linear to V+1, log_softmax

Departures from the paper, as the configuration's file lists them: a
CTC head in place of the RNN-T decoder, conv kernel 31, LayerNorm in the
conv module. Weights are the tensors the benchmark made, in its layout:
linears "w" [in, out]; convolutions "w" [kh, kw, in, out]; the depthwise
kernel "dw" [K, 1, d]; attention "wq", "wk", "wv", "wo", "wr" [d, d] and
"u", "v" [heads, d_h]. Input [B, T, F], output log-probs [T', B, V+1].

`precision` rounds every product's operands (`precision.round_to`).
The relative term is read from the [T, 2T-1] product of q + v with all
offsets by an index gather, offset T-1 first.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from asrbench.counts.flops import conformer as forward_flops  # noqa: F401
from asrbench.reference import spec as S
from asrbench.reference.precision import mm, round_to


def spec(m: Dict) -> S.Spec:
    d, heads, mult, K = (m["d_model"], m["num_heads"], m["ff_mult"],
                         m["conv_kernel"])
    f_sub = -(-(-(-m["feat_size"] // 2)) // 2)
    out: S.Spec = []
    out.append((("sub1", "w"), (3, 3, 1, d), 0.0, 1.0 / 3.0))
    out.append((("sub1", "b"), (d,), 0.0, 1.0 / 3.0))
    h2 = 1.0 / math.sqrt(9 * d)
    out.append((("sub2", "w"), (3, 3, d, d), 0.0, h2))
    out.append((("sub2", "b"), (d,), 0.0, h2))
    S.lin(out, ("sub_proj",), d * f_sub, d)
    unit = math.sqrt(3.0 / d)            # uniform of variance 1 / d
    for i in range(m["num_blocks"]):
        b = ("blocks", i)
        S.ffn(out, b + ("ff1",), d, mult)
        S.ln(out, b + ("mhsa_ln",), d)
        for w in ("wq", "wk", "wv", "wo", "wr"):
            out.append((b + ("mhsa", w), (d, d), 0.0, unit))
        for w in ("u", "v"):
            out.append((b + ("mhsa", w), (heads, d // heads), 0.0,
                        S.BIAS_HALF))
        S.ln(out, b + ("conv", "ln"), d)
        S.lin(out, b + ("conv", "pw1"), d, 2 * d)
        out.append((b + ("conv", "dw"), (K, 1, d), 0.0, unit))
        out.append((b + ("conv", "dw_b"), (d,), 0.0, S.BIAS_HALF))
        S.ln(out, b + ("conv", "ln2"), d)
        S.lin(out, b + ("conv", "pw2"), d, d)
        S.ffn(out, b + ("ff2",), d, mult)
        S.ln(out, b + ("ln_out",), d)
    S.lin(out, ("proj",), d, m["vocab_size"] + 1)
    return out


def output_frames(frames: int) -> int:
    """The stem halves time twice ("SAME": ceil)."""
    return -(-(-(-frames // 2)) // 2)


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["g"] + p["b"]


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _lin(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(x, p["w"], prec) + p["b"]


def _same(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _stem_conv(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """x [B, C, T, F] -> [B, d, ceil(T/2), ceil(F/2)]."""
    kh, kw = p["w"].shape[:2]
    (t0, t1), (f0, f1) = _same(x.shape[2], kh, 2), _same(x.shape[3], kw, 2)
    x = F.pad(x, (f0, f1, t0, t1))
    w = p["w"].permute(3, 2, 0, 1)                      # [out, in, kh, kw]
    y = F.conv2d(round_to(x, prec), round_to(w, prec), stride=2)
    return (y + p["b"][None, :, None, None]).clamp(0.0, 20.0)


def _sinusoids(T: int, d: int, device) -> torch.Tensor:
    """[2T-1, d]: offsets T-1, T-2, ..., -(T-1); sines then cosines."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device)
    inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / d))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mhsa(p: dict, x: torch.Tensor, heads: int, prec: str) -> torch.Tensor:
    """x [T, B, d] -> [T, B, d]."""
    T, B, d = x.shape
    dh = d // heads

    def split(y):                                       # -> [B, H, T, dh]
        return y.reshape(T, B, heads, dh).permute(1, 2, 0, 3)

    q, k, v = (split(mm(x, p[n], prec)) for n in ("wq", "wk", "wv"))
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
    return mm(out, p["wo"], prec)


def _conv_module(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    h = _lin(p["pw1"], _ln(p["ln"], x), prec)          # [T, B, 2d]
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)
    K, _, d = p["dw"].shape
    lo, hi = _same(h.shape[0], K, 1)
    hc = F.pad(h.permute(1, 2, 0), (lo, hi))            # [B, d, T + K - 1]
    w = p["dw"].permute(2, 1, 0)                        # [d, 1, K]
    h = F.conv1d(round_to(hc, prec), round_to(w, prec), groups=d)
    h = h.permute(2, 0, 1) + p["dw_b"]
    return _lin(p["pw2"], _swish(_ln(p["ln2"], h)), prec)


def _ffn(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    h = _swish(_lin(p["w1"], _ln(p["ln"], x), prec))
    return _lin(p["w2"], h, prec)


def forward(params: dict, x: torch.Tensor, heads: int,
            precision: str = "f32") -> torch.Tensor:
    """x [B, T, F] -> log-probs [ceil(T/4), B, V+1]."""
    B = x.shape[0]
    h = _stem_conv(params["sub1"], x[:, None], precision)
    h = _stem_conv(params["sub2"], h, precision)        # [B, d, T', F']
    h = h.permute(0, 2, 3, 1).reshape(B, h.shape[2], -1)  # f * d + c
    h = _lin(params["sub_proj"], h, precision).transpose(0, 1)
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
