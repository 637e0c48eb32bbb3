"""LSTM recurrence kernel: gates i, f, g, o from
pre = xw[t] + bf16(h_{t-1}) @ bf16(W_hh), then c = f*c + i*g, h = o*tanh(c).

Replaces `gasr_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas_raw`
(kernel body `_kernel`): h and c are carried in float32, h is rounded to
bf16 only as the product's operand, W_hh is held in bf16, the product
accumulates in float32 and the gates are float32. Forward or reverse in
time; the output keeps xw's time index.

`lstm_scan` (one direction) and `lstm_scan_bidir` (a forward and a
reverse direction in the same launch) launch a CUDA kernel of
`csrc/lstm_scan.cu` for CUDA tensors (one persistent cooperative launch a
call, c in registers, a step barrier per direction) and run
`lstm_scan_plain` for CPU tensors. `pick_design` chooses the kernel from
(B, H, D) and the card's limits:
  - "resident" where a unit tile's blocks, each holding the 4 x 16 gate
    columns of W_hh in shared memory, fit on the card at once for every
    direction (`max_hidden`: H up to 1008 on an H100); every B, in batch
    groups (past the groups the card holds at once, a block walks
    several);
  - "streamed" past that: W_hh rounded to bf16 once a call into a scratch
    that every step streams from L2 in K stages (bulk copies by a copy
    warp), blocks tiled over batch and unit tiles that own all four gates
    of their units (`stream_plan`).
Neither gives way to the plain version: a launch that fails raises; other
devices raise. `ops/lstm.py::lstm_forward` takes it only where
`_lib.scan_supported` (the JAX package's shape rule) holds.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by lstm_scan / lstm_scan_bidir (one per call,
# whatever the number of directions, either design); those of the streamed
# design among them
launches = 0
streamed_launches = 0

# the resident design's decomposition (csrc/lstm_scan.cu, lstm_scan_kernel)
UNITS = 16            # hidden units a block (its 4 x 16 gate columns)
ROWS = 32             # batch rows a chunk
GROUP_MAX = 128       # batch rows a block at most (4 chunks of c in registers)
SMEM_MAX = 232448     # a block's shared memory on sm_90

# the streamed design (csrc/lstm_scan.cu, lstm_stream_kernel)
STREAM_ALIGN = 128          # H padded to this (K stages of 128 or 64)
STREAM_KS = (128, 64)       # K rows a ring stage, the larger where 2 fit
STREAM_WARPS = 8
STREAM_MAX_STAGES = 8
STREAM_ROWS = (16, 32, 64, 128)   # batch rows a block: m16 tiles 1-8
STREAM_TILES = 16           # accumulator tiles (m16 x n8) a warp at most:
                            # the (2, 2) build spills ~0.5 KB at the
                            # 168-register cap of 288 threads and still
                            # beats the tiling it replaces (PERF.md)


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


def resident_smem(Hp: int) -> int:
    """`lstm_scan_smem` of csrc/lstm_scan.cu: the block's bf16 W^T [64][Hp +
    8], a staged chunk of h [32][Hp + 8] and the K quarters' float32 gate
    tiles [4][32][68]."""
    return 4 * UNITS * (Hp + 8) * 2 + ROWS * (Hp + 8) * 2 + 4 * ROWS * 68 * 4


def resident_groups(D: int, H: int, smem, max_blocks) -> int:
    """How many batch groups a unit tile the card holds at once for D
    directions at width H (its blocks: D x Hp / 16 x groups); 0 past the
    resident limit. `smem(Hp)` gives a block's shared memory,
    `max_blocks(bytes)` how many such blocks the card holds at once."""
    Hp = _round_up(H, UNITS)
    return max_blocks(smem(Hp)) // (D * Hp // UNITS)


def stream_smem(KS: int, MB: int, NU: int, WGK: int, S: int) -> int:
    """`lstm_stream_smem` of csrc/lstm_scan.cu: S stages of the W tile
    [KS][4 NU + 8] and the h tile [MB][KS] (bf16), WGK - 1 float32 partial
    tiles [MB][4 NU + 4] and the ring's 2 S mbarriers."""
    return (S * (MB + 4 * NU + 8) * KS * 2
            + (WGK - 1) * MB * (4 * NU + 4) * 4 + 16 * S)


def warp_grid(MB: int, NU: int, KS: int):
    """(WGM, WGN, WGK): the 8 warps of a streamed block along its rows (1
    or 2 m16 tiles each), its unit octets (1 or 2 each: a warp's n8 tiles
    are the four gates of its octets, at most STREAM_TILES accumulator
    tiles) and each stage's KS rows; the least work a warp (then the
    fewest K slices), or None."""
    best = None
    mt, octets = MB // 16, NU // 8
    for wgm in (1, 2, 4, 8):
        if mt % wgm or mt // wgm > 2:
            continue
        for wgn in (1, 2, 4, 8):
            if wgm * wgn > STREAM_WARPS:
                continue
            wgk = STREAM_WARPS // (wgm * wgn)
            ocw = -(-octets // wgn)
            if (ocw > 2 or (mt // wgm) * 4 * ocw > STREAM_TILES
                    or KS % (16 * wgk)):
                continue
            key = ((mt // wgm) * 4 * ocw * (KS // 16 // wgk), wgk)
            if best is None or key < best[0]:
                best = (key, (wgm, wgn, wgk))
    return None if best is None else best[1]


def stream_plan(B: int, H: int, D: int, blocks: int, smem_max: int = None):
    """The streamed design's decomposition at (B, H) for D directions on
    `blocks` co-resident blocks (one an SM, blocks // D a direction):
    (Hp, KS, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S). Per direction, gB
    batch tiles of MB rows walked by gBr block rows (each takes tiles gb0,
    gb0 + gBr, ..), gN unit tiles of NU units (a multiple of 8; the last
    may hold fewer), each owning the four gate columns of its units; K
    stages of KS rows (128 where two stages fit, else 64); S ring stages,
    as many as shared memory holds (at most STREAM_MAX_STAGES). Chosen for
    the fewest bytes the busiest block reads from L2 a step (its tiles' h
    rows and W columns), then the fewest a step over the card, then the
    fewest batch tiles; for each MB the most block rows whose unit tile
    fits the warps. None where no tiling fits."""
    smem_max = SMEM_MAX if smem_max is None else smem_max
    Hp = _round_up(H, STREAM_ALIGN)
    per_dir = blocks // D
    best = None
    for MB in STREAM_ROWS:
        gB = -(-B // MB)
        if MB > 16 and -(-B // (MB // 2)) == gB:
            continue                 # a smaller tile has as few batch tiles
        for gBr in range(min(gB, per_dir), 0, -1):
            NU = 8 * -(-Hp // (8 * (per_dir // gBr)))
            gN = -(-Hp // NU)
            for KS in STREAM_KS:
                grid = warp_grid(MB, NU, KS)
                if grid is None:
                    continue
                S = min(STREAM_MAX_STAGES,
                        (smem_max - stream_smem(KS, MB, NU, grid[2], 0))
                        // stream_smem(KS, MB, NU, 1, 1))
                if S >= 2:
                    break
            else:
                continue
            walk = -(-gB // gBr)
            cost = (walk * (MB + 4 * NU) * Hp * 2,
                    D * (gB * 4 * Hp * Hp * 2 + gN * B * Hp * 2), gB)
            if best is None or cost < best[0]:
                best = (cost, (Hp, KS, MB, gB, gBr, NU, gN, *grid, S))
            break
    return None if best is None else best[1]


def pick_design(B: int, H: int, D: int, smem, max_blocks, blocks: int):
    """The one rule that picks the kernel: ("resident", (Hp, RB, groups,
    GY)) wherever the resident design fits (`resident_groups` > 0; GY
    blocks a unit tile, each walking groups / GY batch groups), else
    ("streamed", `stream_plan`); (None, None) only where neither fits.
    `smem(Hp)` and `max_blocks(bytes)` describe the resident kernel on the
    card, `blocks` the streamed kernel's co-resident blocks."""
    res = resident_groups(D, H, smem, max_blocks)
    if res > 0:
        Hp, RB, groups = plan(B, H)
        return "resident", (Hp, RB, groups, min(groups, res))
    sp = stream_plan(B, H, D, blocks)
    return ("streamed", sp) if sp is not None else (None, None)


_designs: dict = {}


def _card_design(device, B: int, H: int, D: int):
    key = (device.index, B, H, D)
    if key not in _designs:
        lib = _lib.load("lstm_scan")
        _designs[key] = pick_design(
            B, H, D, lib.lstm_scan_smem, lib.lstm_scan_max_blocks,
            lib.lstm_stream_max_blocks(SMEM_MAX))
    return _designs[key]


def design(device, B: int, H: int, D: int = 1) -> str:
    """The kernel `lstm_scan` (D = 1) / `lstm_scan_bidir` (D = 2) launches
    at (B, H) on this card: "resident" or "streamed"."""
    return _card_design(device, B, H, D)[0]


def max_hidden(D: int) -> int:
    """The largest H (a multiple of 16) the resident design takes on this
    card for D directions, at any B; the streamed design takes the H past
    it."""
    lib = _lib.load("lstm_scan")
    H = 0
    while resident_groups(D, H + UNITS, lib.lstm_scan_smem,
                          lib.lstm_scan_max_blocks) > 0:
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
            "lstm_scan is forward only, as JAX's lstm_scan_pallas_raw, "
            "which has no VJP: train with rnn_impl='scan'")


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
    kind, p = _card_design(dev, B, H, D)
    if kind is None:
        raise ValueError(f"lstm_scan: no tiling of the streamed design fits "
                         f"B={B}, H={H}, {D} direction(s) on this card")
    # the kernels read float32 W_hh and round it to bf16 themselves, and
    # take any H: units past H read as zeros in every gate
    xs = [x.contiguous() for x in xws]
    wf = [(w if w.dtype == torch.float32 else w.float()).contiguous()
          for w in ws]
    h, c = h0.float().contiguous(), c0.float().contiguous()
    out = torch.empty(T, B, D * H, dtype=torch.float32, device=dev)
    rev_mask = sum(1 << d for d, r in enumerate(reverse) if r)
    lib = _lib.load("lstm_scan")
    if kind == "resident":
        Hp, RB, groups, GY = p
        hbf = torch.empty(D, 2, B, Hp, dtype=torch.bfloat16, device=dev)
        # c of the groups a block leaves, where it walks several
        cbuf = torch.empty(D, B, Hp, device=dev) if GY < groups else None
        bar = torch.empty(D * Hp // UNITS * GY, dtype=torch.int64,
                          device=dev)
        err = lib.lstm_scan_launch(
            _lib.ptr(xs[0]), _lib.ptr(xs[-1]), _lib.ptr(wf[0]),
            _lib.ptr(wf[-1]), _lib.ptr(h), _lib.ptr(c), D, T, B, H, Hp, RB,
            GY, rev_mask, _lib.ptr(out), _lib.ptr(hbf),
            None if cbuf is None else _lib.ptr(cbuf), _lib.ptr(bar), None,
            _lib.stream(dev))
    else:
        Hp, KS, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S = p
        wbf = torch.empty(D, gN, Hp, 4 * NU + 8, dtype=torch.bfloat16,
                          device=dev)
        hbf = torch.empty(D, 2, Hp // KS, gB * MB, KS, dtype=torch.bfloat16,
                          device=dev)
        # c of the batch tiles a block leaves, where it walks several
        cbuf = (torch.empty(D, gB * MB, Hp, device=dev) if gB > gBr
                else None)
        bar = torch.empty(D * gBr, dtype=torch.int64, device=dev)
        vec = int(H % 2 == 0 and out.data_ptr() % 8 == 0
                  and all(x.data_ptr() % 8 == 0 for x in xs))
        err = lib.lstm_stream_launch(
            _lib.ptr(xs[0]), _lib.ptr(xs[-1]), _lib.ptr(wf[0]),
            _lib.ptr(wf[-1]), _lib.ptr(h), _lib.ptr(c), D, T, B, H, Hp, KS,
            MB, gB, gBr, NU, gN, WGM, WGN, WGK, S, rev_mask, vec,
            _lib.ptr(out), _lib.ptr(wbf), _lib.ptr(hbf),
            None if cbuf is None else _lib.ptr(cbuf), _lib.ptr(bar), None,
            _lib.stream(dev))
    _lib.check(err, f"lstm_scan ({kind})")
    global launches, streamed_launches
    launches += 1
    streamed_launches += kind == "streamed"
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
