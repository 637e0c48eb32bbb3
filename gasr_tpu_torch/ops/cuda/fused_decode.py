"""Whole-scan prefix beam-search decode and backpointer traceback kernels.

`fused_prefix_decode` replaces
`gasr_tpu/ops/pallas/fused_decode.py::fused_prefix_decode` (`_kernel`,
`_frame_math`): all T frames of the log-domain matched-merge prefix
search in one launch, one thread block per utterance, the beam state
resident in shared memory, the per-frame top-W taken by the block
top-W of `csrc/topk.cuh`. It writes the packed backpointers ys
[T, B, W] and the final beam state.

`traceback` replaces `fused_decode.py::traceback_pallas`
(`_tb_kernel(fused=False)`): one thread per (utterance, slot) walks ys
backwards and writes tokens and frame indices [B, W, L] (-1 where
nothing was emitted) and the start slot.

For CUDA tensors both launch their kernel (`csrc/fused_decode.cu`),
raising outside the envelope W <= 128, W*V <= 16384 (which holds the
TPU kernel's W <= 128 with V <= 128 and W <= 64 with V <= 256). For CPU
tensors they run their plain versions, the eager decoder of
`decoder/beam_search.py` (`_matched_scan`, `_traceback`).
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.decoder import beam_search as _bs
from gasr_tpu_torch.ops.cuda import _lib, topk as _topk

# kernel launches made by fused_prefix_decode / traceback
decode_launches = 0
traceback_launches = 0

MAX_W = _topk.MAX_K        # the block top-W keeps 128 keys
MAX_GRID = 16384           # W*V absorbed-extend flags in shared memory

# packed beam-state field order of the kernel's [NF, B, W] int32 state
FIELDS = ("h1", "h2", "hp1", "hp2", "last", "length", "live", "s1", "s2")


def fused_prefix_decode_plain(log_probs, init, blank_id: int = 0):
    """Plain PyTorch version: the eager matched-merge scan."""
    return _bs._matched_scan(log_probs, init, blank_id)


def traceback_plain(packed_ys, final_lengths, L: int):
    """Plain PyTorch version: the eager reverse walk."""
    return _bs._traceback(packed_ys, final_lengths, L)


def in_envelope(W: int, V: int) -> bool:
    return 1 <= W <= MAX_W and W * V <= MAX_GRID and V < 2 ** 15


def _u32_to_i32(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def pack_state(state) -> torch.Tensor:
    """_BeamState ([B, W] fields) -> [NF, B, W] int32 (floats bit-cast)."""
    f = []
    for name in FIELDS:
        x = getattr(state, name)
        if name in ("h1", "h2", "hp1", "hp2"):
            x = _u32_to_i32(x)
        elif name in ("s1", "s2"):
            x = x.contiguous().view(torch.int32)
        f.append(x.to(torch.int32))
    return torch.stack(f).contiguous()


def unpack_state(packed: torch.Tensor):
    fields = {}
    for i, name in enumerate(FIELDS):
        x = packed[i]
        if name in ("h1", "h2", "hp1", "hp2"):
            x = x.to(torch.int64) & _bs.MASK32
        elif name in ("s1", "s2"):
            x = x.contiguous().view(torch.float32)
        elif name == "live":
            x = x != 0
        fields[name] = x
    return _bs._BeamState(**fields)


def fused_prefix_decode(log_probs: torch.Tensor, init, blank_id: int = 0):
    """log_probs [T, B, V] float32, init `_BeamState` [B, W] ->
    (final `_BeamState`, packed ys [T, B, W] int32)."""
    if log_probs.device.type == "cpu":
        return fused_prefix_decode_plain(log_probs, init, blank_id)
    if log_probs.device.type != "cuda":
        raise ValueError(f"fused_prefix_decode: unsupported device "
                         f"{log_probs.device}")
    T, B, V = log_probs.shape
    W = init.s1.shape[1]
    if not in_envelope(W, V):
        raise ValueError(
            f"fused_prefix_decode: W={W}, V={V} is outside the kernel's "
            f"envelope (W <= {MAX_W}, W*V <= {MAX_GRID}); use "
            "merge_impl='matched'")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} out of range for V={V}")
    lp = log_probs.to(torch.float32).contiguous()
    init_p = pack_state(init).to(lp.device)
    ys = torch.empty(T, B, W, dtype=torch.int32, device=lp.device)
    fin = torch.empty_like(init_p)
    if B == 0:
        return unpack_state(init_p), ys
    lib = _lib.load("fused_decode")
    err = lib.fused_prefix_decode_launch(
        _lib.ptr(lp), _lib.ptr(init_p), T, B, W, V, blank_id, _lib.ptr(ys),
        _lib.ptr(fin), _lib.stream(lp.device))
    _lib.check(err, "fused_prefix_decode")
    global decode_launches
    decode_launches += 1
    return unpack_state(fin), ys


def traceback(packed_ys: torch.Tensor, final_lengths: torch.Tensor, L: int):
    """packed_ys [T, B, W] int32, final_lengths [B, W] -> (tokens,
    timesteps [B, W, L] int32, -1 padded; start_parent [B, W] int32)."""
    if packed_ys.device.type == "cpu":
        return traceback_plain(packed_ys, final_lengths, L)
    if packed_ys.device.type != "cuda":
        raise ValueError(f"traceback: unsupported device {packed_ys.device}")
    T, B, W = packed_ys.shape
    if W > 2 ** 15 or L < 0:
        raise ValueError(f"traceback: W={W} / L={L} out of range")
    ys = packed_ys.to(torch.int32).contiguous()
    lens = final_lengths.to(device=ys.device, dtype=torch.int32).contiguous()
    tok = torch.empty(B, W, L, dtype=torch.int32, device=ys.device)
    ts = torch.empty_like(tok)
    start = torch.empty(B, W, dtype=torch.int32, device=ys.device)
    if B * W == 0:
        return tok, ts, start
    lib = _lib.load("fused_decode")
    err = lib.traceback_launch(_lib.ptr(ys), _lib.ptr(lens), T, B, W, L,
                               _lib.ptr(tok), _lib.ptr(ts), _lib.ptr(start),
                               _lib.stream(ys.device))
    _lib.check(err, "traceback")
    global traceback_launches
    traceback_launches += 1
    return tok, ts, start
