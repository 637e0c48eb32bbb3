"""Elman RNN: multi-layer, optionally bidirectional, tanh recurrence.

h_t = tanh(x_t @ W_ih + h_{t-1} @ W_hh + b_ih + b_hh), stacked layers,
zero initial state, returning the full top-layer hidden history
([T, B, 2H] when bidirectional: forward then reverse direction).
Weights keep the JAX package's layout: W_ih [in, H], W_hh [H, H].

The input projection x @ W_ih for all T is one GEMM outside the
recurrence. The recurrence itself is:
  - impl="scan": a Python loop of float32 `torch.matmul` + tanh steps
    (the JAX package's `lax.scan` path); a bidirectional layer runs both
    directions in one direction-batched loop, as JAX's
    `_scan_bidir_fused` does;
  - impl="pallas": where JAX's shape rule admits it (H % 128 == 0 and
    B % 8 == 0, `ops/cuda/_lib.py::scan_supported`), the hand-written
    CUDA recurrence kernel (`ops/cuda/rnn_scan.py`, W_hh held in bf16,
    float32 accumulate; its plain version for CPU tensors), one call per
    direction; at any other shape the float32 loop, as JAX does.
`rnn_forward_streaming` carries the hidden state across chunks with the
float32 loop, as the JAX package streams with its `lax.scan`.

The loops collect their steps in a list and stack them once: under
autograd a write into a preallocated output is a CopySlices whose
backward clones the whole output each step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gasr_tpu_torch.ops.cuda._lib import scan_supported
from gasr_tpu_torch.ops.cuda.rnn_scan import rnn_scan
from gasr_tpu_torch.ops.linear import uniform_init


def rnn_cell_init(generator: torch.Generator, input_size: int,
                  hidden_size: int, device="cpu",
                  dtype=torch.float32) -> dict:
    """torch.nn.RNN default init: U(-1/sqrt(H), 1/sqrt(H)) on all tensors."""
    bound = 1.0 / (hidden_size ** 0.5)
    shapes = {"w_ih": (input_size, hidden_size),
              "w_hh": (hidden_size, hidden_size),
              "b_ih": (hidden_size,), "b_hh": (hidden_size,)}
    return {k: uniform_init(generator, s, bound, device, dtype)
            for k, s in shapes.items()}


def rnn_cell(params: dict, x_t: torch.Tensor,
             h_prev: torch.Tensor) -> torch.Tensor:
    """One Elman step. x_t: [B, in], h_prev: [B, H] -> [B, H]."""
    pre = (torch.matmul(x_t, params["w_ih"])
           + torch.matmul(h_prev, params["w_hh"])
           + params["b_ih"] + params["b_hh"])
    return torch.tanh(pre)


def rnn_init(generator: torch.Generator, input_size: int, hidden_size: int,
             num_layers: int = 1, bidirectional: bool = False,
             device="cpu", dtype=torch.float32) -> dict:
    """Params: {'layers': [cell, ...], 'layers_rev': [...] if bidirectional}.
    Layer l > 0 takes H inputs (2H when bidirectional)."""
    n_dir = 2 if bidirectional else 1
    layers, layers_rev = [], []
    for l in range(num_layers):
        in_l = input_size if l == 0 else hidden_size * n_dir
        layers.append(rnn_cell_init(generator, in_l, hidden_size, device,
                                    dtype))
        if bidirectional:
            layers_rev.append(rnn_cell_init(generator, in_l, hidden_size,
                                            device, dtype))
    params = {"layers": layers}
    if bidirectional:
        params["layers_rev"] = layers_rev
    return params


def _input_projection(cell: dict, x: torch.Tensor) -> torch.Tensor:
    """[T, B, in] -> [T, B, H]: x @ W_ih + b_ih + b_hh for all T at once."""
    return torch.matmul(x, cell["w_ih"]) + cell["b_ih"] + cell["b_hh"]


def _scan_one_direction(cell: dict, x: torch.Tensor, h0: torch.Tensor,
                        reverse: bool = False, return_final: bool = False,
                        gather: Optional[Callable] = None):
    """One layer and direction: [T, B, in] -> [T, B, H] (and the last
    hidden state [B, H] with return_final). With `gather`, the cell holds
    one rank's columns of H (`rnn_forward_tp`): each step gathers the
    ranks' h into the whole h before the product."""
    xw = _input_projection(cell, x)
    w_hh = cell["w_hh"]
    h = h0
    T = xw.shape[0]
    hs = []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = torch.tanh(xw[t] + torch.matmul(
            h if gather is None else gather(h), w_hh))
        hs.append(h)
    out = torch.stack(hs[::-1] if reverse else hs)
    if return_final:
        return out, h
    return out


def _scan_bidir_fused(cell_f: dict, cell_b: dict, x: torch.Tensor,
                      h0: torch.Tensor) -> torch.Tensor:
    """Both directions in one loop: each step one direction-batched
    [2, B, H] x [2, H, H] product, the reverse direction walking its
    time-reversed input. x: [T, B, in] -> [T, B, 2H]."""
    xw = torch.stack([_input_projection(cell_f, x),
                      _input_projection(cell_b, x).flip(0)], dim=1)
    w_hh = torch.stack([cell_f["w_hh"], cell_b["w_hh"]])
    h = torch.stack([h0, h0])
    steps = []
    for t in range(xw.shape[0]):
        h = torch.tanh(xw[t] + torch.bmm(h, w_hh))
        steps.append(h)
    hs = torch.stack(steps)                         # [T, 2, B, H]
    return torch.cat([hs[:, 0], hs[:, 1].flip(0)], dim=-1)


def _pallas_one_direction(cell: dict, x: torch.Tensor, h0: torch.Tensor,
                          reverse: bool) -> torch.Tensor:
    """The JAX package's `rnn_scan_pallas`: the kernel at the shapes its
    rule admits, the float32 loop at any other."""
    if not scan_supported(x.shape[1], cell["w_hh"].shape[0]):
        return _scan_one_direction(cell, x, h0, reverse)
    return rnn_scan(_input_projection(cell, x), cell["w_hh"], h0, reverse)


def rnn_forward(params: dict, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                impl: str = "scan") -> torch.Tensor:
    """x: [T, B, input_size] time-major -> top-layer history
    [T, B, H * n_dir].

    impl: 'scan' (float32 loop) or 'pallas' (the CUDA recurrence kernel
    on CUDA tensors, its plain bf16-cast version on CPU tensors, where
    the shape rule admits it; else the float32 loop).
    """
    if impl not in ("scan", "pallas"):
        raise ValueError(f"unknown rnn impl {impl!r}")
    layers_rev = params.get("layers_rev")
    B = x.shape[1]
    H = params["layers"][0]["w_hh"].shape[0]
    out = x
    for l, cell in enumerate(params["layers"]):
        h_init = (torch.zeros(B, H, dtype=x.dtype, device=x.device)
                  if h0 is None else h0)
        if layers_rev is not None and impl == "pallas":
            out = torch.cat(
                [_pallas_one_direction(cell, out, h_init, False),
                 _pallas_one_direction(layers_rev[l], out, h_init, True)],
                dim=-1)
        elif layers_rev is not None:
            out = _scan_bidir_fused(cell, layers_rev[l], out, h_init)
        elif impl == "pallas":
            out = _pallas_one_direction(cell, out, h_init, False)
        else:
            out = _scan_one_direction(cell, out, h_init)
    return out


def rnn_forward_tp(params: dict, x: torch.Tensor, gather: Callable,
                   rank: int, n: int) -> torch.Tensor:
    """`rnn_forward(impl="scan")` with every cell's H split over n ranks
    (`parallel/sharding.py::deepspeech_param_specs`: w_ih, w_hh and the
    biases hold this rank's columns).

    x: [T, B, input_size], whole on every rank. `gather(h)` concatenates
    the ranks' [..., H/n] along the last dim, in rank order. Each step
    gathers h (T gathers of [B, H/n] a layer and direction), and a layer's
    whole output is gathered once as the next layer's input. Returns this
    rank's slice of the top layer's history [T, B, H * n_dir] along the
    last dim, the rows of a row-parallel weight that this rank holds: its
    own columns when unidirectional, a slice of the gathered [forward,
    reverse] history when bidirectional."""
    layers_rev = params.get("layers_rev")
    B = x.shape[1]
    h_init = torch.zeros(B, params["layers"][0]["w_hh"].shape[1],
                         dtype=x.dtype, device=x.device)
    out = x
    for l, cell in enumerate(params["layers"]):
        local = [_scan_one_direction(cell, out, h_init, gather=gather)]
        if layers_rev is not None:
            local.append(_scan_one_direction(layers_rev[l], out, h_init,
                                             reverse=True, gather=gather))
        if l == len(params["layers"]) - 1 and layers_rev is None:
            return local[0]
        out = torch.cat([gather(o) for o in local], dim=-1)
    size = out.shape[-1] // n
    return out.narrow(-1, rank * size, size)


def rnn_forward_streaming(params: dict, x: torch.Tensor,
                          h_stack: Optional[torch.Tensor] = None):
    """Unidirectional forward carrying hidden state across chunks.

    x: [Tc, B, in]; h_stack: [num_layers, B, H] (None -> zeros).
    Returns (out [Tc, B, H], new h_stack); chunked calls equal one
    full-sequence `rnn_forward(..., impl="scan")`.
    """
    if "layers_rev" in params:
        raise ValueError("bidirectional RNNs cannot stream")
    layers = params["layers"]
    B = x.shape[1]
    H = layers[0]["w_hh"].shape[0]
    if h_stack is None:
        h_stack = torch.zeros(len(layers), B, H, dtype=x.dtype,
                              device=x.device)
    out = x
    finals = []
    for l, cell in enumerate(layers):
        out, h_fin = _scan_one_direction(cell, out, h_stack[l],
                                         return_final=True)
        finals.append(h_fin)
    return out, torch.stack(finals)
