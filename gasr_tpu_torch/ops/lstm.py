"""LSTM: multi-layer, optionally bidirectional.

Gate order i, f, g, o (torch.nn.LSTM's, as in the JAX package), weights
in the JAX package's layout: w_ih [in, 4H], w_hh [H, 4H], b_ih, b_hh
[4H]; params {'layers': [...], 'layers_rev': [...] if bidirectional},
layer l > 0 taking H * n_dir inputs. The input projection
x @ w_ih + b_ih + b_hh for all T is one GEMM outside the recurrence;
each step is c = sigmoid(f)*c + sigmoid(i)*tanh(g), h = sigmoid(o)*tanh(c)
in float32. The recurrence is:
  - impl="scan": a Python loop of float32 steps (the JAX package's
    `lax.scan`); a bidirectional layer runs both directions in one
    direction-batched loop, as JAX's `_scan_bidir_fused` does;
  - impl="pallas": where JAX's shape rule admits it (H % 128 == 0 and
    B % 8 == 0, `ops/cuda/_lib.py::scan_supported`), the hand-written
    CUDA recurrence kernel (`ops/cuda/lstm_scan.py`, W_hh held in bf16,
    one launch per step for both directions of a layer; its plain
    version for CPU tensors); at any other shape the float32 loop, as
    impl="scan" runs it (JAX runs a bidirectional layer there as two
    one-direction scans, which its docs call numerically identical to
    the fused loop; the tests hold the two to 1e-5).
The loops collect their steps in a list and stack them once: under
autograd a write into a preallocated output is a CopySlices whose
backward clones the whole output each step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gasr_tpu_torch.ops.cuda._lib import scan_supported
from gasr_tpu_torch.ops.cuda.lstm_scan import lstm_scan, lstm_scan_bidir
from gasr_tpu_torch.ops.linear import uniform_init


def lstm_cell_init(generator: torch.Generator, input_size: int,
                   hidden_size: int, device="cpu",
                   dtype=torch.float32) -> dict:
    """torch.nn.LSTM default init: U(-1/sqrt(H), 1/sqrt(H)) on all tensors."""
    bound = 1.0 / (hidden_size ** 0.5)
    H4 = 4 * hidden_size
    shapes = {"w_ih": (input_size, H4), "w_hh": (hidden_size, H4),
              "b_ih": (H4,), "b_hh": (H4,)}
    return {k: uniform_init(generator, s, bound, device, dtype)
            for k, s in shapes.items()}


def lstm_init(generator: torch.Generator, input_size: int, hidden_size: int,
              num_layers: int = 1, bidirectional: bool = False,
              device="cpu", dtype=torch.float32) -> dict:
    n_dir = 2 if bidirectional else 1
    layers, layers_rev = [], []
    for l in range(num_layers):
        in_l = input_size if l == 0 else hidden_size * n_dir
        layers.append(lstm_cell_init(generator, in_l, hidden_size, device,
                                     dtype))
        if bidirectional:
            layers_rev.append(lstm_cell_init(generator, in_l, hidden_size,
                                             device, dtype))
    params = {"layers": layers}
    if bidirectional:
        params["layers_rev"] = layers_rev
    return params


def _input_projection(cell: dict, x: torch.Tensor) -> torch.Tensor:
    """[T, B, in] -> [T, B, 4H]: x @ W_ih + b_ih + b_hh for all T at once."""
    return torch.matmul(x, cell["w_ih"]) + cell["b_ih"] + cell["b_hh"]


def _step(xw_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
          w_hh: torch.Tensor):
    """One float32 step of one direction ([B, H] states) or of a stack of
    directions ([D, B, H] states, [D, H, 4H] weights)."""
    pre = xw_t + torch.matmul(h, w_hh)
    i, f, g, o = pre.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _scan_one_direction(cell: dict, x: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One layer and direction in float32: [T, B, in] -> [T, B, H]."""
    xw = _input_projection(cell, x)
    h, c = h0, c0
    T = xw.shape[0]
    hs = []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = _step(xw[t], h, c, cell["w_hh"])
        hs.append(h)
    return torch.stack(hs[::-1] if reverse else hs)


def _scan_bidir_fused(cell_f: dict, cell_b: dict, x: torch.Tensor,
                      h0: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Both directions in one loop: each step one direction-batched
    [2, B, H] x [2, H, 4H] product, the reverse direction walking its
    time-reversed input. x: [T, B, in] -> [T, B, 2H]."""
    xw = torch.stack([_input_projection(cell_f, x),
                      _input_projection(cell_b, x).flip(0)], dim=1)
    w_hh = torch.stack([cell_f["w_hh"], cell_b["w_hh"]])
    h, c = torch.stack([h0, h0]), torch.stack([c0, c0])
    steps = []
    for t in range(xw.shape[0]):
        h, c = _step(xw[t], h, c, w_hh)
        steps.append(h)
    hs = torch.stack(steps)                         # [T, 2, B, H]
    return torch.cat([hs[:, 0], hs[:, 1].flip(0)], dim=-1)


def lstm_forward(params: dict, x: torch.Tensor,
                 state0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 impl: str = "scan") -> torch.Tensor:
    """x: [T, B, in] -> [T, B, H * n_dir]. Zero initial state by default;
    `state0` = (h0, c0), each [B, H], starts every layer and direction."""
    if impl not in ("scan", "pallas"):
        raise ValueError(f"unknown lstm impl {impl!r}")
    layers = params["layers"]
    layers_rev = params.get("layers_rev")
    B = x.shape[1]
    H = layers[0]["w_hh"].shape[0]
    kernel = impl == "pallas" and scan_supported(B, H)
    out = x
    for l, cell in enumerate(layers):
        if state0 is None:
            h0 = torch.zeros(B, H, dtype=x.dtype, device=x.device)
            c0 = torch.zeros(B, H, dtype=x.dtype, device=x.device)
        else:
            h0, c0 = state0
        if layers_rev is not None and kernel:
            rev = layers_rev[l]
            out = lstm_scan_bidir(_input_projection(cell, out),
                                  _input_projection(rev, out),
                                  cell["w_hh"], rev["w_hh"], h0, c0)
        elif layers_rev is not None:
            out = _scan_bidir_fused(cell, layers_rev[l], out, h0, c0)
        elif kernel:
            out = lstm_scan(_input_projection(cell, out), cell["w_hh"], h0,
                            c0)
        else:
            out = _scan_one_direction(cell, out, h0, c0, False)
    return out
