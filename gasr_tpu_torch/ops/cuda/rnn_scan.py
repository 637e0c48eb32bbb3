"""Elman recurrence kernel: out[t] = tanh(xw[t] + bf16(h_{t-1}) @ bf16(W_hh)).

Replaces `gasr_tpu/ops/pallas/rnn_scan.py::rnn_scan_pallas_raw`
(kernel body `_kernel`): h is rounded to bf16 before the product, W_hh
is held in bf16, the product accumulates in float32, and the float32
sum with xw goes through tanh. Forward or reverse in time; the output
keeps xw's time index.

`rnn_scan` launches a CUDA kernel of `csrc/rnn_scan.cu` for CUDA tensors
(one persistent cooperative launch a call, a step barrier between steps)
and runs `rnn_scan_plain` for CPU tensors. `pick_design` chooses the
kernel from (B, H) and the card's shared memory:
  - "resident" wherever the resident plan (`plan`) exists, H up to
    `max_hidden` (2688 on an H100): W_hh stays in shared memory, K split
    over clusters of 8 blocks;
  - "streamed" everywhere else: W_hh rounded to bf16 once a call into a
    scratch that every step streams from L2 in K stages (bulk copies by a
    copy warp), blocks tiled over batch and units together
    (`stream_plan`).
Neither gives way to the plain version: a launch that fails raises.
Other weight dtypes or devices raise. `ops/rnn.py::rnn_forward` takes it
only where `_lib.scan_supported` (the JAX package's shape rule) holds.
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by rnn_scan (one per call, either design); those of
# the streamed design among them
launches = 0
streamed_launches = 0

# the kernel's decomposition (csrc/rnn_scan.cu)
CLUSTER = 8           # blocks of a cluster: W_hh's K rows split 8 ways
UNIT_ALIGN = 8        # a cluster's units: a multiple of the n8 tile
NU_MAX = 192          # units a cluster at most
MAX_CLUSTERS = 32     # the most clusters a call is split into
CHUNK_ROWS = (128, 64)   # batch rows a chunk, the larger where it fits
SMEM_MAX = 232448     # a block's shared memory on sm_90


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(H: int, smem, max_clusters):
    """The kernel's decomposition at hidden width H: (Hp, NU, G, MB), H
    padded to a multiple of 128 (so each of the 8 K slices is a multiple
    of 16), G clusters of NU units each (the last may hold fewer), batch
    chunks of MB = 128 rows (64 where 128 do not fit), or None past the
    resident limit. `smem(NU, Kb, MB)` gives a block's shared memory,
    `max_clusters(NU, MB, bytes)` how many clusters of that build the card
    holds at once; the most clusters that fit win."""
    Hp = _round_up(H, 128)
    Kb = Hp // CLUSTER
    for G in range(min(Hp // UNIT_ALIGN, MAX_CLUSTERS), 0, -1):
        NU = _round_up(-(-Hp // G), UNIT_ALIGN)
        need = {MB: smem(NU, Kb, MB) for MB in CHUNK_ROWS}
        if NU > NU_MAX or min(need.values()) > SMEM_MAX:
            return None          # fewer clusters would need more
        Gu = -(-Hp // NU)
        for MB, nbytes in need.items():
            if nbytes <= SMEM_MAX and Gu <= max_clusters(NU, MB, nbytes):
                return Hp, NU, Gu, MB
    return None


# the streamed design (csrc/rnn_scan.cu, rnn_stream_kernel)
STREAM_K = 128              # K rows a ring stage
STREAM_WARPS = 8
STREAM_MAX_STAGES = 8
STREAM_ROWS = (16, 32, 64, 128)   # batch rows a block: m16 tiles 1-8
STREAM_NTW = 8              # n8 tiles a warp at most


def stream_smem(MB: int, NU: int, WGK: int, S: int) -> int:
    """`rnn_stream_smem` of csrc/rnn_scan.cu: S stages of the W tile
    [STREAM_K][NU] and the h tile [MB][STREAM_K] (bf16), WGK - 1 float32
    partial tiles [MB][NU + 4] and the ring's 2 S mbarriers."""
    return (S * (MB + NU) * STREAM_K * 2 + (WGK - 1) * MB * (NU + 4) * 4
            + 16 * S)


def warp_grid(MB: int, NU: int):
    """(WGM, WGN, WGK): the 8 warps of a streamed block along its rows (1
    or 2 m16 tiles each), its units (at most STREAM_NTW n8 tiles each) and
    each stage's K; the least work a warp (then the fewest K slices), or
    None."""
    best = None
    mt = MB // 16
    for wgm in (1, 2, 4, 8):
        if mt % wgm or mt // wgm > 2:
            continue
        for wgn in (1, 2, 4, 8):
            if wgm * wgn > STREAM_WARPS:
                continue
            wgk = STREAM_WARPS // (wgm * wgn)
            ntw = -(-(NU // 8) // wgn)
            if ntw > STREAM_NTW or STREAM_K % (16 * wgk):
                continue
            key = ((mt // wgm) * ntw * (STREAM_K // 16 // wgk), wgk)
            if best is None or key < best[0]:
                best = (key, (wgm, wgn, wgk))
    return None if best is None else best[1]


def stream_plan(B: int, H: int, blocks: int, smem_max: int = None):
    """The streamed design's decomposition at (B, H) on `blocks`
    co-resident blocks (one an SM): (Hp, MB, gB, gBr, NU, gN, WGM, WGN,
    WGK, S). gB batch tiles of MB rows, walked by gBr block rows (each
    block row takes tiles gb0, gb0 + gBr, ..); gN unit tiles of NU (a
    multiple of 8 with NU / 8 odd, so that the kernel's ldmatrix rows of
    the W tile fall in distinct bank groups; the last may hold fewer); S
    ring stages, as many as
    shared memory holds (at most STREAM_MAX_STAGES). Chosen for the fewest
    bytes the busiest block reads from L2 a step (its tiles' h rows and W
    columns), then the fewest a step over the card (gB Hp^2 2 for W, gN B
    Hp 2 for h), then the fewest batch tiles; for each MB the most block
    rows whose unit tile fits the warps. None where no tiling fits."""
    smem_max = SMEM_MAX if smem_max is None else smem_max
    Hp = _round_up(H, STREAM_K)
    best = None
    for MB in STREAM_ROWS:
        gB = -(-B // MB)
        if MB > 16 and -(-B // (MB // 2)) == gB:
            continue                 # a smaller tile has as few batch tiles
        for gBr in range(min(gB, blocks), 0, -1):
            n8 = -(-Hp // (8 * (blocks // gBr)))
            NU = 8 * (n8 + 1 - n8 % 2)          # NU / 8 odd
            gN = -(-Hp // NU)
            grid = warp_grid(MB, NU)
            if grid is None:
                continue
            S = min(STREAM_MAX_STAGES,
                    (smem_max - stream_smem(MB, NU, grid[2], 0))
                    // stream_smem(MB, NU, 1, 1))
            if S < 2:
                continue
            walk = -(-gB // gBr)
            cost = (walk * (MB + NU) * Hp * 2,
                    gB * Hp * Hp * 2 + gN * B * Hp * 2, gB)
            if best is None or cost < best[0]:
                best = (cost, (Hp, MB, gB, gBr, NU, gN, *grid, S))
            break
    return None if best is None else best[1]


def pick_design(B: int, H: int, smem, max_clusters, blocks: int):
    """The one rule that picks the kernel: ("resident", `plan`) wherever
    the resident plan exists, else ("streamed", `stream_plan`); (None,
    None) only where neither fits."""
    p = plan(H, smem, max_clusters)
    if p is not None:
        return "resident", p
    sp = stream_plan(B, H, blocks)
    return ("streamed", sp) if sp is not None else (None, None)


_plans: dict = {}
_designs: dict = {}


def _card_design(device, B: int, H: int):
    key = (device.index, B, H)
    if key not in _designs:
        lib = _lib.load("rnn_scan")
        _designs[key] = pick_design(B, H, lib.rnn_scan_smem,
                                    lib.rnn_scan_max_clusters,
                                    lib.rnn_stream_max_blocks(SMEM_MAX))
    return _designs[key]


def design(device, B: int, H: int) -> str:
    """The kernel `rnn_scan` launches at (B, H) on this card: "resident"
    or "streamed"."""
    return _card_design(device, B, H)[0]


def _card_plan(device, H: int):
    key = (device.index, H)
    if key not in _plans:
        lib = _lib.load("rnn_scan")
        _plans[key] = plan(H, lib.rnn_scan_smem, lib.rnn_scan_max_clusters)
    return _plans[key]


def max_hidden(device) -> int:
    """The largest H the resident design takes on this card (a multiple
    of 128); the streamed design takes the H past it."""
    H = 128
    while _card_plan(device, H + 128) is not None:
        H += 128
    return H if _card_plan(device, H) is not None else 0


def rnn_scan_plain(xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
                   reverse: bool = False,
                   weight_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Plain PyTorch version: the same casts, step by step.

    Products of two bf16 values are exact in float32, so the float32
    matmul of the up-cast operands is the bf16 product with float32
    accumulation."""
    w = w_hh.to(weight_dtype).float()
    out = torch.empty_like(xw)
    h = h0.float()
    steps = range(xw.shape[0] - 1, -1, -1) if reverse else range(xw.shape[0])
    for t in steps:
        h = torch.tanh(xw[t] + torch.matmul(h.to(weight_dtype).float(), w))
        out[t] = h
    return out


def rnn_scan(xw: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
             reverse: bool = False,
             weight_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xw: [T, B, H] float32 input projection (+ biases); w_hh: [H, H];
    h0: [B, H]. Returns the hidden history [T, B, H] float32."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xw, w_hh, h0)):
        raise NotImplementedError(
            "rnn_scan is forward only, as JAX's rnn_scan_pallas_raw, "
            "which has no VJP: train with rnn_impl='scan'")
    if xw.device.type == "cpu":
        return rnn_scan_plain(xw, w_hh, h0, reverse, weight_dtype)
    if xw.device.type != "cuda":
        raise ValueError(f"rnn_scan: unsupported device {xw.device}")
    if weight_dtype != torch.bfloat16:
        raise ValueError("rnn_scan: the CUDA kernel holds W_hh in bf16 only")
    if xw.ndim != 3 or xw.dtype != torch.float32:
        raise ValueError("rnn_scan: xw must be float32 [T, B, H]")
    T, B, H = xw.shape
    if tuple(w_hh.shape) != (H, H) or tuple(h0.shape) != (B, H):
        raise ValueError(f"rnn_scan: w_hh {tuple(w_hh.shape)} / h0 "
                         f"{tuple(h0.shape)} do not fit xw {tuple(xw.shape)}")
    for t in (w_hh, h0):
        if t.device != xw.device:
            raise ValueError("rnn_scan: all tensors must be on one device")
    if T * B * H == 0:
        return torch.empty_like(xw)
    kind, p = _card_design(xw.device, B, H)
    if kind is None:
        raise ValueError(f"rnn_scan: no tiling of the streamed design fits "
                         f"B={B}, H={H} on this card")
    # the kernels read float32 W_hh and round it to bf16 themselves, and
    # take any H: units and K rows past H read as zeros
    w = w_hh if w_hh.dtype == torch.float32 else w_hh.float()
    xw, w, h = xw.contiguous(), w.contiguous(), h0.float().contiguous()
    out = torch.empty_like(xw)
    lib = _lib.load("rnn_scan")
    stream = _lib.stream(xw.device)
    if kind == "resident":
        Hp, NU, G, MB = p
        hbf = torch.empty(2, B, Hp, dtype=torch.bfloat16, device=xw.device)
        vec = int(H % 4 == 0 and xw.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        bar = torch.empty(G * CLUSTER, dtype=torch.int64, device=xw.device)
        err = lib.rnn_scan_launch(
            _lib.ptr(xw), _lib.ptr(w), _lib.ptr(h), T, B, H, Hp, NU, G, MB,
            int(reverse), vec, _lib.ptr(out), _lib.ptr(hbf), _lib.ptr(bar),
            None, stream)
    else:
        Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S = p
        wbf = torch.empty(gN, Hp, NU, dtype=torch.bfloat16, device=xw.device)
        hbf = torch.empty(2, Hp // STREAM_K, gB * MB, STREAM_K,
                          dtype=torch.bfloat16, device=xw.device)
        vec = int(H % 2 == 0 and xw.data_ptr() % 8 == 0
                  and out.data_ptr() % 8 == 0)
        bar = torch.empty(gBr * gN, dtype=torch.int64, device=xw.device)
        err = lib.rnn_stream_launch(
            _lib.ptr(xw), _lib.ptr(w), _lib.ptr(h), T, B, H, Hp, MB, gB, gBr,
            NU, gN, WGM, WGN, WGK, S, int(reverse), vec, _lib.ptr(out),
            _lib.ptr(wbf), _lib.ptr(hbf), _lib.ptr(bar), None, stream)
    _lib.check(err, f"rnn_scan ({kind})")
    global launches, streamed_launches
    launches += 1
    streamed_launches += kind == "streamed"
    return out
