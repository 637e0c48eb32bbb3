"""Whole-scan prefix beam-search decode and backpointer traceback kernels.

`fused_prefix_decode` replaces
`gasr_tpu/ops/pallas/fused_decode.py::fused_prefix_decode` (`_kernel`,
`_frame_math`): all T frames of the log-domain matched-merge prefix
search in one launch, one thread block per utterance, the beam state
resident in shared memory, the per-frame top-W taken by the block
top-W of `csrc/topk.cuh`. It writes the packed backpointers ys
[T, B, W] and the final beam state. With `lm_q` (the quantized [V+1, V]
bigram table) it launches the kernel's shallow-fusion instantiation,
which adds lm_q[last + 1, v] to every extend (JAX's `lm_q` variant).

`traceback` replaces `fused_decode.py::traceback_pallas`
(`_tb_kernel(fused=False)`): one thread per (utterance, slot) walks ys
backwards and writes tokens and frame indices [B, W, L] (-1 where
nothing was emitted) and the start slot.

`traceback_overlay` replaces `fused_decode.py::traceback_overlay_pallas`
(`_tb_kernel(fused=True)`), the streaming chunk's traceback: one warp
per (utterance, slot) walks the chunk's ys, writes the chunk's
emissions at their absolute positions and timesteps, and copies the
rest of its row from row start_parent of the previous chunk's buffers,
into fresh output buffers.

For CUDA tensors each launches its kernel (`csrc/fused_decode.cu`); the
decode kernel raises outside JAX's `_use_pallas` shape rule (W <= 128
and V <= 128, or W <= 64 and V <= 256), which `in_envelope` states and
the decoder checks before it launches anything; with an LM also V <= 255,
JAX's rule for the `lm_q` variant. For CPU tensors they
run their plain versions, the eager decoder of `decoder/beam_search.py`
(`_matched_scan`, `_traceback`).
"""

from __future__ import annotations

import torch

from gasr_tpu_torch.decoder import beam_search as _bs
from gasr_tpu_torch.ops.cuda import _lib

# kernel launches made by fused_prefix_decode / traceback /
# traceback_overlay; decode_lm_launches counts the decode launches that
# ran the shallow-fusion instantiation (also counted in decode_launches)
decode_launches = 0
decode_lm_launches = 0
traceback_launches = 0
overlay_launches = 0

# packed beam-state field order of the kernel's [NF, B, W] int32 state
FIELDS = ("h1", "h2", "hp1", "hp2", "last", "length", "live", "s1", "s2")


def fused_prefix_decode_plain(log_probs, init, blank_id: int = 0,
                              lm_q=None):
    """Plain PyTorch version: the eager matched-merge scan."""
    return _bs._matched_scan(log_probs, init, blank_id, lm_q)


def traceback_plain(packed_ys, final_lengths, L: int):
    """Plain PyTorch version: the eager reverse walk."""
    return _bs._traceback(packed_ys, final_lengths, L)


def traceback_overlay_plain(packed_ys, final_lengths, base_tokens,
                            base_timesteps, t_offset: int):
    """Plain PyTorch version: the eager reverse walk with the base
    overlay."""
    return _bs._traceback(packed_ys, final_lengths, base_tokens.shape[2],
                          base_tokens, base_timesteps, t_offset)


def in_envelope(W: int, V: int, has_lm: bool = False) -> bool:
    """JAX `_use_pallas`'s shape rule, which the decode kernel takes
    (the block top-W keeps at most 128 keys; W*V <= 16384 absorbed-extend
    flags sit in shared memory); with an LM, V <= 255 as well."""
    return W >= 1 and V >= 1 and ((W <= 128 and V <= 128)
                                  or (W <= 64 and V <= 256)) \
        and not (has_lm and V > 255)


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
    return _bs._BeamState(tb=torch.zeros_like(packed[0]), **fields)


def fused_prefix_decode(log_probs: torch.Tensor, init, blank_id: int = 0,
                        lm_q=None):
    """log_probs [T, B, V] float32, init `_BeamState` [B, W], lm_q None or
    the bf16-quantized [V+1, V] float32 table -> (final `_BeamState`,
    packed ys [T, B, W] int32)."""
    if log_probs.device.type == "cpu":
        return fused_prefix_decode_plain(log_probs, init, blank_id, lm_q)
    if log_probs.device.type != "cuda":
        raise ValueError(f"fused_prefix_decode: unsupported device "
                         f"{log_probs.device}")
    T, B, V = log_probs.shape
    W = init.s1.shape[1]
    if not in_envelope(W, V, lm_q is not None):
        raise ValueError(
            f"fused_prefix_decode: W={W}, V={V} is outside the kernel's "
            "envelope (W <= 128 and V <= 128, or W <= 64 and V <= 256; "
            "V <= 255 with an LM); use merge_impl='matched'")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} out of range for V={V}")
    if lm_q is not None and (tuple(lm_q.shape) != (V + 1, V)
                             or lm_q.dtype != torch.float32
                             or lm_q.device != log_probs.device):
        raise ValueError(f"fused_prefix_decode: lm_q must be float32 "
                         f"[{V + 1}, {V}] on {log_probs.device}")
    lp = log_probs.to(torch.float32).contiguous()
    lm = None if lm_q is None else lm_q.contiguous()
    init_p = pack_state(init).to(lp.device)
    ys = torch.empty(T, B, W, dtype=torch.int32, device=lp.device)
    fin = torch.empty_like(init_p)
    if B == 0:
        return unpack_state(init_p), ys
    lib = _lib.load("fused_decode")
    err = lib.fused_prefix_decode_launch(
        _lib.ptr(lp), _lib.ptr(init_p),
        None if lm is None else _lib.ptr(lm), T, B, W, V, blank_id,
        _lib.ptr(ys), _lib.ptr(fin), _lib.stream(lp.device))
    _lib.check(err, "fused_prefix_decode")
    global decode_launches, decode_lm_launches
    decode_launches += 1
    decode_lm_launches += lm is not None
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


def traceback_overlay(packed_ys: torch.Tensor, final_lengths: torch.Tensor,
                      base_tokens: torch.Tensor, base_timesteps: torch.Tensor,
                      t_offset: int):
    """One streaming chunk's traceback. packed_ys [Tc, B, W] int32,
    final_lengths [B, W] (absolute, at chunk end), base_tokens /
    base_timesteps [B, W, L] int32 (the buffers at chunk start),
    t_offset the absolute frame of the chunk's first frame -> (tokens,
    timesteps [B, W, L] in fresh tensors, start_parent [B, W] int32)."""
    if packed_ys.device.type == "cpu":
        return traceback_overlay_plain(packed_ys, final_lengths, base_tokens,
                                       base_timesteps, t_offset)
    if packed_ys.device.type != "cuda":
        raise ValueError(f"traceback_overlay: unsupported device "
                         f"{packed_ys.device}")
    Tc, B, W = packed_ys.shape
    if base_tokens.ndim != 3 or base_tokens.shape[:2] != (B, W) or \
            base_timesteps.shape != base_tokens.shape:
        raise ValueError("traceback_overlay: base buffers must be [B, W, L] "
                         f"with B={B}, W={W}")
    if W > 2 ** 15 or not -2 ** 31 <= t_offset < 2 ** 31 - Tc:
        raise ValueError(f"traceback_overlay: W={W} / t_offset={t_offset} "
                         "out of range")
    L = base_tokens.shape[2]
    dev = packed_ys.device
    ys = packed_ys.to(torch.int32).contiguous()
    lens = final_lengths.to(device=dev, dtype=torch.int32).contiguous()
    base_tok = base_tokens.to(device=dev, dtype=torch.int32).contiguous()
    base_ts = base_timesteps.to(device=dev, dtype=torch.int32).contiguous()
    tok = torch.empty(B, W, L, dtype=torch.int32, device=dev)
    ts = torch.empty_like(tok)
    start = torch.empty(B, W, dtype=torch.int32, device=dev)
    if B * W == 0:
        return tok, ts, start
    lib = _lib.load("fused_decode")
    err = lib.traceback_overlay_launch(
        _lib.ptr(ys), _lib.ptr(lens), _lib.ptr(base_tok), _lib.ptr(base_ts),
        Tc, B, W, L, int(t_offset), _lib.ptr(tok), _lib.ptr(ts),
        _lib.ptr(start), _lib.stream(dev))
    _lib.check(err, "traceback_overlay")
    global overlay_launches
    overlay_launches += 1
    return tok, ts, start
