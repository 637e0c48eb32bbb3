"""wav2vec 2.0 CTC (Baevski et al. 2020, arXiv:2006.11477), the
architecture of `facebook/wav2vec2-large-960h-lv60-self` (Large, LV-60 +
self-training; HuBERT, XLS-R and MMS share it): the port's own model
family, with no JAX counterpart. Forward only.

The input is the raw 16 kHz waveform, carried by the port's contract x
[B, T, F] as frames of F = 160 samples (10 ms), flattened to [B, 160 T].

    feature encoder : 7 x [Conv1d (kernel k_i, stride s_i, with bias),
                      LayerNorm over the 512 channels, GELU]
                      (k = 10, 3, 3, 3, 3, 2, 2; s = 5, 2, 2, 2, 2, 2, 2:
                      one frame every 320 samples, 20 ms)
    projection      : LayerNorm(512), linear 512 -> d
    position        : x += GELU(grouped Conv1d(x)), kernel 128 padded 64
                      on each side, the last frame dropped, 16 groups; the
                      weight normalised per kernel tap: w[t] = g[t] v[t] /
                      ||v[t]||
    N layers        : x += W_o MHSA(LN(x)); x += W2 GELU(W1 LN(x) + b1) + b2
                      (pre-LN, "stable layer norm"); biased q, k, v and
                      o; scores (q . k) / sqrt(d_h), no position term
    head            : LN(x), linear d -> V + 1 (blank 0), log_softmax

Time-major [T', B, d] through the layers, channels-last [B, L, C]
through the convolutions (so each LayerNorm is a row operation). GELU is
the exact erf form everywhere; every LayerNorm's eps is 1e-5.

compute_dtype (bf16) is the conformers' policy: params stay float32,
every product and convolution takes bf16 operands with float32 sums, the
activations and the residual stream are carried at bf16, LayerNorm
statistics, GELU, the softmax and the log_softmax are computed in
float32. A convolution's output is rounded to bf16 once and its bias
added at bf16 (`ops/conv.py::conv1d_nwc`). On a bf16 CUDA forward
outside autograd each LayerNorm is an `add_ln` launch (with the residual
add before it in the layers: 2 a layer), each linear's epilogue a
`bias_act` launch (qkv, W1 with GELU, W2: 3 a layer, and the projection),
the attention a `flash_mhsa` launch (`ops/attention.py::mhsa`), and the
positional convolution with its bias and GELU one `pos_conv` launch
(`ops/cuda/pos_conv.py`, at 64 channels a group; the same sums in another
order than cuDNN's, then the same roundings); the feature encoder's
convolutions stay on cuDNN.

Params (the benchmark's weights have the same tree): "fe" [7] of {"w"
[k, C_in, C] (WIO), "b", "ln"}; "fp" {"ln", "w" [512, d], "b"}; "pos"
{"g" [K], "v" [K, d / groups, d], "b" [d]}; "layers" [N] of {"ln1",
"attn" {"wq", "wk", "wv", "wo" [d, d], "bq", "bk", "bv", "bo" [d]},
"ln2", "ff" {"w1", "w2"}}; "ln_out"; "proj" {"w" [d, V + 1], "b"}.
Spans: "model.feature_encoder" (the seven convolutions with their norms
and GELUs) and "model.pos_conv".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gasr_tpu_torch.config import Config
from gasr_tpu_torch.models.conformer import _add_ln, _dtype, _ln_init, _lin
from gasr_tpu_torch.ops.attention import mhsa, mhsa_init
from gasr_tpu_torch.ops.conv import conv1d_nwc
from gasr_tpu_torch.ops.cuda.pos_conv import conv_gelu
from gasr_tpu_torch.ops.linear import linear, linear_init, uniform_init
from gasr_tpu_torch.runtime.profiler import span

_PRESETS = {
    "wav2vec2_large_lv60": dict(
        d_model=1024, num_blocks=24, num_heads=16, ffn_dim=4096,
        conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2), pos_kernel=128, pos_groups=16),
}
PRESETS = tuple(_PRESETS)
# x carries the waveform, not log-mel features (`Pipeline.audio_features`)
INPUT = "waveform"


def _preset(config: Config) -> dict:
    p = dict(_PRESETS[config.model])
    if config.linear_size and config.linear_size != p["d_model"]:
        p["d_model"] = config.linear_size
    if config.num_blocks is not None:
        p["num_blocks"] = config.num_blocks
    return p


def output_length(samples: int, kernels=(10, 3, 3, 3, 3, 2, 2),
                  strides=(5, 2, 2, 2, 2, 2, 2)) -> int:
    """Frames of `samples` samples after the feature encoder: floor((L -
    k) / s) + 1 a layer, 0 once a layer has fewer samples than its
    kernel."""
    n = samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1 if n >= k else 0
    return n


def wav2vec2_init(generator: torch.Generator, config: Config,
                  device="cpu") -> dict:
    """Params with torch.nn's initialisation scales (uniform of
    1 / sqrt(fan_in)), LayerNorm gains 1 and biases 0, and the positional
    convolution's g equal to ||v|| a tap (w = v), drawn from
    `generator`."""
    hp = _preset(config)
    d = hp["d_model"]
    fe, c_in = [], 1
    for c, k in zip(hp["conv_dim"], hp["conv_kernel"]):
        bound = (1.0 / (c_in * k)) ** 0.5
        fe.append({"w": uniform_init(generator, (k, c_in, c), bound, device),
                   "b": uniform_init(generator, (c,), bound, device),
                   "ln": _ln_init(c, device)})
        c_in = c
    K, G = hp["pos_kernel"], hp["pos_groups"]
    v = uniform_init(generator, (K, d // G, d), (G / (d * K)) ** 0.5, device)
    p = {"fe": fe,
         "fp": dict(linear_init(generator, c_in, d, device),
                    ln=_ln_init(c_in, device)),
         "pos": {"g": torch.linalg.vector_norm(v, dim=(1, 2)), "v": v,
                 "b": uniform_init(generator, (d,), (G / (d * K)) ** 0.5,
                                   device)},
         "layers": [
             {"ln1": _ln_init(d, device),
              "attn": mhsa_init(generator, d, device),
              "ln2": _ln_init(d, device),
              "ff": {"w1": linear_init(generator, d, hp["ffn_dim"], device),
                     "w2": linear_init(generator, hp["ffn_dim"], d, device)}}
             for _ in range(hp["num_blocks"])],
         "ln_out": _ln_init(d, device)}
    p["proj"] = linear_init(generator, d, config.output_size, device)
    return p


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics at x's dtype (`add_ln` on a bf16
    CUDA x outside autograd)."""
    return _add_ln(p, x, keep=False)[1]


def _conv(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor, stride: int,
          cd) -> torch.Tensor:
    """h [B, L, C] -> conv + bias [B, L', O] at h's dtype (the conv's
    float32 sums rounded once, the bias added at that dtype)."""
    if cd is not None:
        w, b = w.to(cd), b.to(cd)
    return conv1d_nwc(h, w, stride).add_(b)


def _pos_weight(p: dict) -> torch.Tensor:
    """The weight-normalised positional kernel [K, d / groups, d]: w[t] =
    g[t] v[t] / ||v[t]|| (weight_norm over every dim but the tap's)."""
    v = p["v"]
    return v * (p["g"] / torch.linalg.vector_norm(v, dim=(1, 2)))[:, None,
                                                                    None]


def wav2vec2_apply(config: Config, params: dict, x: torch.Tensor,
                   compute_dtype=None, attn_impl: str = "auto",
                   **_) -> torch.Tensor:
    """x: [B, T, F] (T frames of F samples) -> log-probs [T', B, V + 1]
    float32, T' = `output_length(T F)`. Every frame is attended, padding
    too (as the conformers' forwards do)."""
    hp = _preset(config)
    cd = _dtype(compute_dtype)
    B, T, Fr = x.shape
    h = x.reshape(B, T * Fr, 1)
    h = h.float() if cd is None else h.to(cd)
    with span("model.feature_encoder"):
        for p, s in zip(params["fe"], hp["conv_stride"]):
            h = F.gelu(_ln(p["ln"], _conv(p["w"], p["b"], h, s, cd)))
    h = _lin(params["fp"], _ln(params["fp"]["ln"], h), cd)     # [B, T', d]
    with span("model.pos_conv"):
        w, b = _pos_weight(params["pos"]), params["pos"]["b"]
        if cd is not None:
            w, b = w.to(cd), b.to(cd)
        pc = conv_gelu(h, w, b, hp["pos_groups"])
    layers = params["layers"]
    norms = [blk["ln1"] for blk in layers] + [params["ln_out"]]
    # time-major from here; each residual add with the LayerNorm after it
    x, hn = _add_ln(norms[0], h.transpose(0, 1), pc.transpose(0, 1))
    for i, blk in enumerate(layers):
        a = mhsa(blk["attn"], hn, hp["num_heads"], cd, attn_impl)
        x, hn = _add_ln(blk["ln2"], x, a)
        f = _lin(blk["ff"]["w2"], _lin(blk["ff"]["w1"], hn, cd, "gelu"), cd)
        x, hn = _add_ln(norms[i + 1], x, f, keep=i + 1 < len(layers))
    logits = linear(params["proj"], hn, None, cd)
    return torch.log_softmax(logits, dim=-1)
