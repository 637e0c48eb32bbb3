"""Plain wav2vec 2.0 CTC forward (Baevski et al. 2020, arXiv:2006.11477;
`facebook/wav2vec2-large-960h-lv60-self`, whose `Wav2Vec2ForCTC` runs
`do_stable_layer_norm` and `feat_extract_norm` "layer"), as the
`wav2vec2_large_lv60` configuration runs it, in float32. It follows
`transformers`' `modeling_wav2vec2.py`:

    input    : x [B, T, 160], ten ms frames of the 16 kHz waveform,
               flattened to [B, 1, 160 T]
    encoder  : 7 x [Conv1d (kernel k_i, stride s_i, bias), LayerNorm over
               the channels, GELU]; L_out = floor((L_in - k_i) / s_i) + 1
    project  : LayerNorm(512), linear 512 -> d
    position : x += GELU(Conv1d(x)), kernel K padded K // 2 on each side,
               the last frame dropped (K even), `pos_groups` groups, the
               weight w[t] = g[t] v[t] / ||v[t]|| (`weight_norm`, dim 2)
    layer    : x += W_o MHSA(LN(x)); x += W2 GELU(W1 LN(x) + b1) + b2,
               every projection biased; scores (q . k) / sqrt(d_h)
    head     : LN(x), linear d -> V + 1 (blank 0), log_softmax

GELU is the exact erf form; every LayerNorm's eps is 1e-5. Departures
from the published model, as the configuration's file lists them: padded
samples are encoded and attended unmasked (HF masks them when it is given
an attention mask); no dropout, LayerDrop or SpecAugment; the program
computes in mixed precision (this reference in float32); the benchmark
decodes with a beam of 100 (pyctcdecode's default) where HF decodes
greedily. Weights are the tensors the benchmark made, in its layout:
linears "w" [in, out]; convolutions "w" [k, in / groups, out]; the
positional kernel "g" [K], "v" [K, d / groups, d]. Output log-probs
[T', B, V+1].

`precision` rounds every product's and convolution's operands
(`precision.round_to`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from asrbench.counts.wav2vec2 import (  # noqa: F401
    SAMPLES_PER_FRAME, encoder_lengths, wav2vec2 as forward_flops)
from asrbench.reference import spec as S
from asrbench.reference.conformer import _lin, _ln
from asrbench.reference.precision import mm, round_to

KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)


def output_frames(frames: int) -> int:
    """Log-prob frames of `frames` 10 ms frames: the published encoder's
    seven convolutions over 160 samples a frame."""
    return encoder_lengths(SAMPLES_PER_FRAME * frames, KERNELS, STRIDES)[-1]


def spec(m: Dict) -> S.Spec:
    d, K, G = m["d_model"], m["pos_kernel"], m["pos_groups"]
    out: S.Spec = []
    c_in = 1
    for i, (k, c) in enumerate(zip(m["conv_kernel"], m["conv_dim"])):
        h = 1.0 / math.sqrt(k * c_in)
        out.append((("fe", i, "w"), (k, c_in, c), 0.0, h))
        out.append((("fe", i, "b"), (c,), 0.0, h))
        S.ln(out, ("fe", i, "ln"), c)
        c_in = c
    S.ln(out, ("fp", "ln"), c_in)
    S.lin(out, ("fp",), c_in, d)
    # g at the norm a tap of v has (uniform of half-width h over d / G x d
    # values), so that w = g v / ||v|| is about v
    h = 1.0 / math.sqrt(K * (d // G))
    g = h * math.sqrt((d // G) * d / 3.0)
    out.append((("pos", "g"), (K,), g, 0.1 * g))
    out.append((("pos", "v"), (K, d // G, d), 0.0, h))
    out.append((("pos", "b"), (d,), 0.0, h))
    hd = 1.0 / math.sqrt(d)
    for i in range(m["num_blocks"]):
        b = ("layers", i)
        S.ln(out, b + ("ln1",), d)
        for n in ("q", "k", "v", "o"):
            out.append((b + ("attn", "w" + n), (d, d), 0.0, hd))
            out.append((b + ("attn", "b" + n), (d,), 0.0, hd))
        S.ln(out, b + ("ln2",), d)
        S.lin(out, b + ("ff", "w1"), d, m["ffn_dim"])
        S.lin(out, b + ("ff", "w2"), m["ffn_dim"], d)
    S.ln(out, ("ln_out",), d)
    S.lin(out, ("proj",), d, m["vocab_size"] + 1)
    return out


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
          pad: int, groups: int, prec: str) -> torch.Tensor:
    """x [B, C, L], w [k, C / groups, O] -> [B, O, L']."""
    y = F.conv1d(round_to(x, prec), round_to(w.permute(2, 1, 0), prec),
                 stride=stride, padding=pad, groups=groups)
    return y + b[:, None]


def _mhsa(p: dict, x: torch.Tensor, heads: int, prec: str) -> torch.Tensor:
    """x [B, T, d] -> [B, T, d]."""
    B, T, d = x.shape
    dh = d // heads

    def split(y):                                       # -> [B, H, T, dh]
        return y.reshape(B, T, heads, dh).transpose(1, 2)

    q, k, v = (split(mm(x, p["w" + n], prec) + p["b" + n])
               for n in ("q", "k", "v"))
    attn = torch.softmax(mm(q, k.transpose(-1, -2), prec) / math.sqrt(dh),
                         dim=-1)
    out = mm(attn, v, prec).transpose(1, 2).reshape(B, T, d)
    return mm(out, p["wo"], prec) + p["bo"]


def forward(params: dict, x: torch.Tensor, m: Dict,
            precision: str = "f32") -> torch.Tensor:
    """x [B, T, 160] -> log-probs [output_frames(T), B, V+1]."""
    B = x.shape[0]
    h = x.reshape(B, 1, -1)                             # [B, 1, samples]
    for p, s in zip(params["fe"], m["conv_stride"]):
        h = _conv(h, p["w"], p["b"], s, 0, 1, precision)
        h = F.gelu(_ln(p["ln"], h.transpose(1, 2)).transpose(1, 2))
    h = h.transpose(1, 2)                               # [B, T', 512]
    h = _lin(params["fp"], _ln(params["fp"]["ln"], h), precision)
    pos, K = params["pos"], m["pos_kernel"]
    w = pos["v"] * (pos["g"] / torch.linalg.vector_norm(
        pos["v"], dim=(1, 2)))[:, None, None]
    pc = _conv(h.transpose(1, 2), w, pos["b"], 1, K // 2, m["pos_groups"],
               precision)
    if K % 2 == 0:
        pc = pc[:, :, :-1]
    h = h + F.gelu(pc).transpose(1, 2)
    for blk in params["layers"]:
        h = h + _mhsa(blk["attn"], _ln(blk["ln1"], h), m["num_heads"],
                      precision)
        f = F.gelu(_lin(blk["ff"]["w1"], _ln(blk["ln2"], h), precision))
        h = h + _lin(blk["ff"]["w2"], f, precision)
    h = _ln(params["ln_out"], h)
    logits = _lin(params["proj"], h, precision)
    return torch.log_softmax(logits, dim=-1).transpose(0, 1)


def apply(params: dict, x: torch.Tensor, model: Dict,
          precision: str) -> torch.Tensor:
    """`forward` with TF32 off for cuBLAS and cuDNN (restored after), so
    that a float32 product is float32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return forward(params, x, model, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
