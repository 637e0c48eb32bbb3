"""LSTM recurrence kernel: gates i, f, g, o from
pre = xw[t] + bf16(h_{t-1}) @ bf16(W_hh), then c = f*c + i*g, h = o*tanh(c).

Replaces `gasr_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas_raw`
(kernel body `_kernel`): h and c are carried in float32, h is rounded to
bf16 only as the product's operand, W_hh is held in bf16, the product
accumulates in float32 and the gates are float32. Forward or reverse in
time; the output keeps xw's time index.

`lstm_scan` (one direction) and `lstm_scan_bidir` (a forward and a
reverse direction in the same launch) launch the CUDA kernel
(`csrc/lstm_scan.cu`: one persistent cooperative launch a call, W_hh
resident in shared memory, c in registers, a step barrier per direction)
for CUDA tensors and run `lstm_scan_plain` for CPU tensors. Every B goes
through the kernel in one launch (past the batch groups the card holds
at once, a block walks several); H up to the resident limit
(`max_hidden`: a unit tile's blocks, each holding 4 x 16 columns of
W_hh, must fit on the card at once for every direction), past which it
raises `ValueError`; other devices raise.
`ops/lstm.py::lstm_forward` takes it only where `_lib.scan_supported`
(the JAX package's shape rule) holds.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by lstm_scan / lstm_scan_bidir (one per call,
# whatever the number of directions)
launches = 0

# the kernel's decomposition (csrc/lstm_scan.cu)
UNITS = 16            # hidden units a block (its 4 x 16 gate columns)
ROWS = 32             # batch rows a chunk
GROUP_MAX = 128       # batch rows a block at most (4 chunks of c in registers)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(B: int, H: int):
    """The kernel's grid at (B, H): (Hp, RB, groups), H padded to a
    multiple of 16 and the batch cut into `groups` groups of RB rows (a
    multiple of 32, at most 128); a direction has Hp / 16 unit tiles, and
    each unit tile as many blocks as there are groups, or as the card
    holds at once (`_resident_groups`)."""
    Hp = _round_up(H, UNITS)
    RB = _round_up(-(-B // -(-B // GROUP_MAX)), ROWS)
    return Hp, RB, -(-B // RB)


_fit: dict = {}


def _resident_groups(D: int, H: int) -> int:
    """How many batch groups a unit tile the card holds at once for D
    directions at width H (its blocks: D x Hp / 16 x groups); 0 past the
    resident limit."""
    Hp = _round_up(H, UNITS)
    key = (torch.cuda.current_device(), D, Hp)
    if key not in _fit:
        lib = _lib.load("lstm_scan")
        _fit[key] = (lib.lstm_scan_max_blocks(lib.lstm_scan_smem(Hp))
                     // (D * Hp // UNITS))
    return _fit[key]


def max_hidden(D: int) -> int:
    """The largest H (a multiple of 16) the kernel takes on this card for
    D directions, at any B."""
    H = 0
    while _resident_groups(D, H + UNITS) > 0:
        H += UNITS
    return H


def lstm_scan_plain(xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the same casts, step by step (products of
    two bf16 values are exact in float32, so the float32 matmul of the
    up-cast operands is the bf16 product with float32 accumulation)."""
    H = w_hh.shape[0]
    w = w_hh.to(torch.bfloat16).float()
    out = xw.new_empty(xw.shape[0], xw.shape[1], H)
    h, c = h0.float(), c0.float()
    steps = range(xw.shape[0] - 1, -1, -1) if reverse else range(xw.shape[0])
    for t in steps:
        pre = xw[t] + torch.matmul(h.to(torch.bfloat16).float(), w)
        i = torch.sigmoid(pre[:, 0 * H:1 * H])
        f = torch.sigmoid(pre[:, 1 * H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[t] = h
    return out


def _forward_only(*tensors) -> None:
    """JAX's `jax.grad` through `lstm_scan_pallas_raw` fails; so does this
    kernel's wrapper under autograd, rather than leave the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "lstm_scan is forward only, as JAX's lstm_scan_pallas_raw (the "
            "backward comes with training, ROADMAP.md Queue 1 item 12)")


def _check(xws, ws, h0, c0) -> None:
    dev = xws[0].device
    if dev.type != "cuda":
        raise ValueError(f"lstm_scan: unsupported device {dev}")
    shape = tuple(xws[0].shape)
    if len(shape) != 3 or shape[2] % 4:
        raise ValueError(f"lstm_scan: xw must be [T, B, 4H], got {shape}")
    T, B, H4 = shape
    H = H4 // 4
    for xw in xws:
        if xw.dtype != torch.float32 or tuple(xw.shape) != shape:
            raise ValueError("lstm_scan: xw must be float32 [T, B, 4H], the "
                             "same for both directions")
    for w in ws:
        if tuple(w.shape) != (H, H4):
            raise ValueError(f"lstm_scan: w_hh {tuple(w.shape)} does not fit "
                             f"xw {shape}")
    for s in (h0, c0):
        if tuple(s.shape) != (B, H):
            raise ValueError(f"lstm_scan: h0 / c0 {tuple(s.shape)} do not "
                             f"fit xw {shape}")
    for t in (*xws, *ws, h0, c0):
        if t.device != dev:
            raise ValueError("lstm_scan: all tensors must be on one device")


def _launch(xws: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
            h0: torch.Tensor, c0: torch.Tensor,
            reverse: Sequence[bool]) -> torch.Tensor:
    """The kernel over len(xws) directions -> [T, B, D*H] float32."""
    D = len(xws)
    T, B, H4 = xws[0].shape
    H = H4 // 4
    dev = h0.device
    if T * B * H == 0:
        return xws[0].new_empty(T, B, D * H)
    resident = _resident_groups(D, H)
    if resident == 0:
        raise ValueError(
            f"lstm_scan: H={H} with {D} direction(s) is past the kernel's "
            f"resident limit H <= {max_hidden(D)} on this card (W_hh stays "
            f"in shared memory, 4H^2 x 2 x D bytes over blocks that must "
            f"all be resident at once)")
    Hp, RB, groups = plan(B, H)
    GY = min(groups, resident)
    # the kernel reads float32 W_hh and rounds it to bf16 itself, and takes
    # any H: units past H read as zeros in every gate
    xs = [x.contiguous() for x in xws]
    wf = [(w if w.dtype == torch.float32 else w.float()).contiguous()
          for w in ws]
    h, c = h0.float().contiguous(), c0.float().contiguous()
    out = torch.empty(T, B, D * H, dtype=torch.float32, device=dev)
    hbf = torch.empty(D, 2, B, Hp, dtype=torch.bfloat16, device=dev)
    # c of the groups a block leaves, where it walks several
    cbuf = torch.empty(D, B, Hp, device=dev) if GY < groups else None
    bar = torch.empty(D * Hp // UNITS * GY, dtype=torch.int64, device=dev)
    rev_mask = sum(1 << d for d, r in enumerate(reverse) if r)
    err = _lib.load("lstm_scan").lstm_scan_launch(
        _lib.ptr(xs[0]), _lib.ptr(xs[-1]), _lib.ptr(wf[0]), _lib.ptr(wf[-1]),
        _lib.ptr(h), _lib.ptr(c), D, T, B, H, Hp, RB, GY, rev_mask,
        _lib.ptr(out), _lib.ptr(hbf),
        None if cbuf is None else _lib.ptr(cbuf), _lib.ptr(bar), None,
        _lib.stream(dev))
    _lib.check(err, "lstm_scan")
    global launches
    launches += 1
    return out


def lstm_scan(xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """xw: [T, B, 4H] float32 input projection (+ biases); w_hh: [H, 4H];
    h0, c0: [B, H]. Returns the hidden history [T, B, H] float32."""
    _forward_only(xw, w_hh, h0, c0)
    if xw.device.type == "cpu":
        return lstm_scan_plain(xw, w_hh, h0, c0, reverse)
    _check([xw], [w_hh], h0, c0)
    return _launch([xw], [w_hh], h0, c0, [reverse])


def lstm_scan_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor,
                    w_f: torch.Tensor, w_b: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor) -> torch.Tensor:
    """A bidirectional layer's recurrences: the forward direction on
    (xw_f, w_f), the reverse one on (xw_b, w_b), both from (h0, c0).
    Returns [T, B, 2H], the same as concatenating `lstm_scan(xw_f, w_f,
    h0, c0)` and `lstm_scan(xw_b, w_b, h0, c0, reverse=True)`; on the card
    one launch runs both directions, each on blocks of its own."""
    _forward_only(xw_f, xw_b, w_f, w_b, h0, c0)
    if xw_f.device.type == "cpu":
        return torch.cat(
            [lstm_scan_plain(xw_f, w_f, h0, c0, False),
             lstm_scan_plain(xw_b, w_b, h0, c0, True)], dim=-1)
    _check([xw_f, xw_b], [w_f, w_b], h0, c0)
    return _launch([xw_f, xw_b], [w_f, w_b], h0, c0, [False, True])
