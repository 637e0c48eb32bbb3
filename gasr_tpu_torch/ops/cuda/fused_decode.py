"""Whole-scan prefix beam-search decode and backpointer traceback kernels.

`fused_prefix_decode` replaces
`gasr_tpu/ops/pallas/fused_decode.py::fused_prefix_decode` (`_kernel`,
`_frame_math`): all T frames of the log-domain matched-merge prefix
search in one launch, one thread block per utterance, the beam state
resident in shared memory, the per-frame top-W taken by the
threshold-filtered top-W of `csrc/topk.cuh` (exact: a candidate below a
threshold that W real candidates reach is dropped with one compare, the
rest are merged in per-warp sorted lists and ranked), three block
barriers a frame. It writes the packed backpointers ys
[T, B, W] and the final beam state. With `lm_q` (the quantized [V+1, V]
bigram table) it launches the kernel's shallow-fusion instantiation,
which adds lm_q[last + 1, v] to every extend (JAX's `lm_q` variant).

`traceback` replaces `fused_decode.py::traceback_pallas`
(`_tb_kernel(fused=False)`): one block per utterance (a few where W >
128) stages ys in shared memory in chunks of frames from the end
backwards, one thread per slot walks them and collects its row's
emissions on chip, and every row goes out once, coalesced, its -1 cells
included; tokens and frame indices [B, W, L] and the start slot.
`traceback_plan` gives the chunk length and blocks an utterance,
`traceback_passes` the rest.

`traceback_overlay` replaces `fused_decode.py::traceback_overlay_pallas`
(`_tb_kernel(fused=True)`), the streaming chunk's traceback: one warp
per (utterance, slot) walks the chunk's ys, writes the chunk's
emissions at their absolute positions and timesteps, and copies the
rest of its row from row start_parent of the previous chunk's buffers,
into fresh output buffers.

`tp_frame` replaces `fused_decode.py::fused_tp_frame` (`_tp_kernel`):
one frame of the vocab-sharded decode on one shard's window [lo, hi),
the shard's W local winners in (score desc, global index asc) order with
their keys and updated fields. `tp_frames` ("fused_frame") runs the same
kernel once a card a frame: each block merges the previous frame's n
lists first (a parity buffer on its card), so the loop holds nothing but
launches. `tp_scan` replaces `fused_decode.py::fused_tp_scan`
(`_tp_scan_kernel`, `_merge2_top`): all T frames of every shard of a
model group, the per-frame winner exchange and merge inside the kernel
(`csrc/decode_tp.cu`, `csrc/exchange.cuh`), in the design `pick_design`
names by placement and shard count: clusters of n blocks on one card, or
a persistent grid that pushes its lists into the peers' inboxes. Their
plain versions are `tp_frame_plain`, `tp_frame_merged_plain` /
`tp_frames_plain` (the merged frame on every shard, frame by frame) and
`tp_scan_plain`.

For CUDA tensors each launches its kernel (`csrc/fused_decode.cu`,
`csrc/decode_tp.cu`); the
decode kernel raises outside JAX's `_use_pallas` shape rule (W <= 128
and V <= 128, or W <= 64 and V <= 256), which `in_envelope` states and
the decoder checks before it launches anything; with an LM also V <= 255,
JAX's rule for the `lm_q` variant; the vocab-sharded kernels raise
outside JAX's (`parallel/decode_tp.py:391-397`): W <= 128 and windows of
at most 128 ids, and for `tp_scan` also n <= V <= 256. For CPU tensors
they run their plain versions, the eager decoder of
`decoder/beam_search.py` (`_matched_scan`, `_traceback`) and
`tp_frame_plain` / `tp_frames_plain` / `tp_scan_plain`.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from gasr_tpu_torch.decoder import beam_search as _bs
from gasr_tpu_torch.ops.cuda import _lib
from gasr_tpu_torch.ops.cuda.topk import monotone_bits, topk_plain

# kernel launches made by fused_prefix_decode / traceback /
# traceback_overlay; decode_lm_launches counts the decode launches that
# ran the shallow-fusion instantiation (also counted in decode_launches)
decode_launches = 0
decode_lm_launches = 0
traceback_launches = 0
overlay_launches = 0
# kernel launches made by tp_frame / tp_scan (one tp_scan launch per card
# that holds shards of the group)
tp_frame_launches = 0
tp_scan_launches = 0

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
    (the lists of the top-W keep at most 128 keys; W*V <= 16384
    absorbed-extend flags sit in shared memory); with an LM, V <= 255 as
    well."""
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


# the traceback kernel's blocks (csrc/fused_decode.cu): at most TB_ROWS
# slots a block, chunks of at most TB_MAX_CHUNK frames whose two staging
# buffers take at most TB_STAGE_BYTES where one frame's do; the rows'
# emission buffers take what is left of a block's SMEM_MAX
TB_ROWS = 128
TB_MAX_CHUNK = 64
TB_STAGE_BYTES = 32 * 1024
SMEM_MAX = 232448


def traceback_plan(W: int):
    """(TC, G): chunks of TC frames, G blocks an utterance (W / G slots
    each, at most TB_ROWS); TC the largest power of two up to
    TB_MAX_CHUNK whose two staged chunks fit TB_STAGE_BYTES (1 if none
    does)."""
    G = max(1, -(-W // TB_ROWS))
    TC = TB_MAX_CHUNK
    while TC > 1 and 2 * TC * W * 4 > TB_STAGE_BYTES:
        TC //= 2
    return TC, G


def traceback_passes(T: int, W: int, L: int, TC: int, G: int):
    """`tb_passes` of csrc/fused_decode.cu: (CAP, passes). A row keeps at
    most min(L, T) emissions; CAP of them fit its buffer (4 bytes each
    where T <= 2^17, else 6) beside the staged chunks; the walk runs once
    per window of CAP (0 passes: not even one emission a row fits)."""
    rows, need = -(-W // G), min(L, T)
    entry = 4 if T <= 1 << 17 else 6
    cap = min(need, (SMEM_MAX - 2 * TC * W * 4) // (rows * entry))
    if need == 0:
        return cap, 1
    return cap, (-(-need // cap) if cap > 0 else 0)


def traceback_smem(T: int, W: int, L: int, TC: int, G: int) -> int:
    """`traceback_smem` of csrc/fused_decode.cu: the two staged chunks and
    the rows' emission buffers of CAP entries."""
    cap, _ = traceback_passes(T, W, L, TC, G)
    entry = 4 if T <= 1 << 17 else 6
    return 2 * TC * W * 4 + -(-W // G) * max(cap, 1) * entry


def traceback(packed_ys: torch.Tensor, final_lengths: torch.Tensor, L: int):
    """packed_ys [T, B, W] int32, final_lengths [B, W] -> (tokens,
    timesteps [B, W, L] int32, -1 padded; start_parent [B, W] int32)."""
    if packed_ys.device.type == "cpu":
        return traceback_plain(packed_ys, final_lengths, L)
    if packed_ys.device.type != "cuda":
        raise ValueError(f"traceback: unsupported device {packed_ys.device}")
    T, B, W = packed_ys.shape
    plan = traceback_plan(W) if W > 0 else (1, 1)
    if W > 2 ** 15 or L < 0 or (
            W > 0 and traceback_passes(T, W, L, *plan)[1] == 0):
        raise ValueError(f"traceback: W={W} / L={L} out of range")
    ys = packed_ys.to(torch.int32).contiguous()
    lens = final_lengths.to(device=ys.device, dtype=torch.int32).contiguous()
    tok = torch.empty(B, W, L, dtype=torch.int32, device=ys.device)
    ts = torch.empty_like(tok)
    start = torch.empty(B, W, dtype=torch.int32, device=ys.device)
    if B * W == 0:
        return tok, ts, start
    TC, G = plan
    lib = _lib.load("fused_decode")
    err = lib.traceback_launch(_lib.ptr(ys), _lib.ptr(lens), T, B, W, L, TC,
                               G, _lib.ptr(tok), _lib.ptr(ts),
                               _lib.ptr(start), _lib.stream(ys.device))
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


# ------------------------------------------------ vocab-sharded decode

TP_MAX_WINDOW = 128     # vocab ids per shard (JAX: ceil(V/n) <= 128)
TP_SCAN_MAX_V = 256     # tp_scan keeps the whole frame row (JAX: V <= 256)
TP_CLUSTER_PORTABLE = 8  # blocks a cluster on every sm_90 card
TP_CLUSTER_MAX = 16     # with the non-portable cluster size allowed
# the most shards "auto" gives the cluster design: on an H100 it is the
# faster design at n <= 2 and the push design at n >= 4 (PERF.md §6:
# `scripts/torch_tp_designs.py`, three shapes)
TP_CLUSTER_PICK = 2
TP_MAX_CARDS = 8        # cards a tp_frame launch writes its lists to
TP_DESIGNS = ("cluster", "push")
_LOW32 = 0xFFFFFFFF


def shard_bounds(V: int, n: int) -> List[Tuple[int, int]]:
    """Shard s of n owns vocab ids [s*V // n, (s+1)*V // n): balanced,
    every shard non-empty for n <= V (JAX: `decode_tp.py:242-243`)."""
    return [(s * V // n, (s + 1) * V // n) for s in range(n)]


def rank_keys(vals: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """The kernels' 64-bit candidate key (`csrc/topk.cuh`: monotone score
    bits high, inverted global index low) with its sign bit flipped, as
    int64: larger = earlier in (score desc, global index asc), unique per
    candidate."""
    return (monotone_bits(vals) - 2 ** 31) * 2 ** 32 + (_LOW32 - gidx.long())


def key_index(keys: torch.Tensor) -> torch.Tensor:
    """The global candidate index w*V + v that a key names."""
    return _LOW32 - (keys & _LOW32)


def tp_frame_plain(f_loc, f_last, f_blank, state, lo: int, hi: int, V: int,
                   blank_id: int = 0):
    """Plain PyTorch version: the matched-merge frame of
    `decoder/beam_search.py::_frame_step` on the window's candidates."""
    st = unpack_state(state)
    B, W = st.s1.shape
    Vw = hi - lo
    dev = f_loc.device
    pb, pnb, live = st.s1, st.s2, st.live
    last = st.last.long()
    length = st.length.long()
    total = _bs._logaddexp(pb, pnb)
    last_clip = last.clamp(0, V - 1)

    # replicated parent match (identical on every shard)
    k2 = (st.h2 * 31 + length) & _bs.MASK32
    kp2 = (st.hp2 * 31 + (length - 1)) & _bs.MASK32
    eq = ((st.h1[:, :, None] == st.hp1[:, None, :])
          & (k2[:, :, None] == kp2[:, None, :])
          & live[:, :, None] & live[:, None, :])
    has_match = eq.any(dim=1)
    match = eq.to(torch.int32).argmax(dim=1)

    stay_pb = total + f_blank[:, None]
    stay_pnb = torch.where(length > 0, pnb + f_last, _bs.NEG_INF)
    pb_m = torch.gather(pb, 1, match)
    pnb_m = torch.gather(pnb, 1, match)
    last_m = torch.gather(last, 1, match)
    ext_base_m = torch.where(last_m == last, pb_m,
                             _bs._logaddexp(pb_m, pnb_m))
    ext_contrib = torch.where(has_match, ext_base_m + f_last, _bs.NEG_INF)
    stay_pnb = _bs._logaddexp(stay_pnb, ext_contrib)
    stay_score = torch.where(live, _bs._logaddexp(stay_pb, stay_pnb),
                             _bs.DEAD_KEY_LOG)

    # the window's extends [B, W, Vw]; the absorbed extend is excluded on
    # the shard whose window holds its cell
    vs = lo + torch.arange(Vw, device=dev)
    is_rep = vs[None, None, :] == last[:, :, None]
    ext_pnb = torch.where(is_rep, pb[:, :, None], total[:, :, None]) \
        + f_loc[:, None, :]
    owned = has_match & (last_clip >= lo) & (last_clip < hi)
    excl_idx = torch.where(owned, match * Vw + (last_clip - lo), W * Vw)
    excl = torch.zeros(B, W * Vw + 1, dtype=torch.bool, device=dev)
    excl.scatter_(1, excl_idx, True)
    excl = excl[:, :W * Vw].view(B, W, Vw)
    valid = (vs != blank_id)[None, None, :] & live[:, :, None] & ~excl
    cand = torch.where(valid, ext_pnb, _bs.DEAD_KEY_LOG)
    cand = torch.where((vs == blank_id)[None, None, :],
                       stay_score[:, :, None], cand)

    # local index w*Vw + j orders as the global index w*V + lo + j
    top_vals, idx = topk_plain(cand.reshape(B, W * Vw), W)
    idx = idx.long()
    w_sel = idx // Vw
    v_sel = lo + idx % Vw
    is_stay = v_sel == blank_id
    new_live = top_vals > _bs.DEAD_KEY_LOG * 0.5

    def g(x):
        return torch.gather(x, 1, w_sel)

    h1g, h2g = g(st.h1), g(st.h2)
    sel_ext_pnb = torch.gather(ext_pnb.reshape(B, W * Vw), 1, idx)
    n_last = torch.where(is_stay, g(last), v_sel)
    vp1 = v_sel + 1
    new = _bs._BeamState(
        h1=torch.where(is_stay, h1g, (h1g * _bs.M1 + vp1) & _bs.MASK32),
        h2=torch.where(is_stay, h2g, (h2g * _bs.M2 + vp1) & _bs.MASK32),
        hp1=torch.where(is_stay, g(st.hp1), h1g),
        hp2=torch.where(is_stay, g(st.hp2), h2g),
        last=n_last.to(torch.int32),
        length=(g(length) + (~is_stay).long()).to(torch.int32),
        tb=torch.zeros_like(st.length),
        live=new_live,
        s1=torch.where(new_live & is_stay, g(stay_pb), _bs.NEG_INF),
        s2=torch.where(new_live, torch.where(is_stay, g(stay_pnb),
                                             sel_ext_pnb), _bs.NEG_INF),
    )
    ys = _bs._pack_ys(w_sel, n_last, (~is_stay) & new_live)
    return ys, rank_keys(top_vals, w_sel * V + v_sel), pack_state(new)


def tp_frame(f_loc: torch.Tensor, f_last: torch.Tensor,
             f_blank: torch.Tensor, state: torch.Tensor, lo: int, hi: int,
             V: int, blank_id: int = 0):
    """One vocab-sharded frame on the shard that owns vocab ids [lo, hi).

    f_loc [B, hi - lo] float32: the frame's log-probs of those ids (a view
    into the full row will do: only its last stride must be 1); f_last
    [B, W] = f[b, clip(last[b, w], 0, V-1)] and f_blank [B] = f[b, blank],
    both from the full row; state [NF, B, W] int32 packed. Returns (ys
    [B, W] int32, keys [B, W] int64, fin [NF, B, W] int32): the shard's W
    best candidates in (score desc, global index asc) order, their packed
    backpointers, their `rank_keys` (`key_index` gives w*V + v) and their
    updated state fields. V is the full vocab: any V with hi - lo <= 128
    (JAX's envelope, `decode_tp.py:391`). On the card this is the frame
    kernel of `tp_frames` with one input list, the state itself."""
    if state.device.type == "cpu":
        return tp_frame_plain(f_loc, f_last, f_blank, state, lo, hi, V,
                              blank_id)
    if state.device.type != "cuda":
        raise ValueError(f"tp_frame: unsupported device {state.device}")
    if state.ndim != 3 or state.shape[0] != len(FIELDS) or \
            state.dtype != torch.int32:
        raise ValueError("tp_frame: state must be int32 [NF, B, W]")
    _, B, W = state.shape
    if not (1 <= W <= 128 and 0 <= lo < hi <= V
            and hi - lo <= TP_MAX_WINDOW and V < 2 ** 15):
        raise ValueError(f"tp_frame: W={W}, [lo, hi)=[{lo}, {hi}), V={V} is "
                         f"outside the kernel's envelope (W <= 128, "
                         f"1 <= hi - lo <= {TP_MAX_WINDOW}, V < 32768)")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} out of range for V={V}")
    for name, t, shape in (("f_loc", f_loc, (B, hi - lo)),
                           ("f_last", f_last, (B, W)),
                           ("f_blank", f_blank, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"tp_frame: {name} must be float32 {list(shape)}"
                             f", got {t.dtype} {list(t.shape)}")
        if t.device != state.device:
            raise ValueError("tp_frame: all tensors must be on one device")
    if f_loc.stride(1) != 1:
        f_loc = f_loc.contiguous()
    f_last, f_blank = f_last.contiguous(), f_blank.contiguous()
    state = state.contiguous()
    dev = state.device
    ys = torch.empty(B, W, dtype=torch.int32, device=dev)
    keys = torch.empty(B, W, dtype=torch.int64, device=dev)
    fin = torch.empty_like(state)
    if B == 0:
        return ys, keys, fin
    lib = _lib.load("decode_tp")
    outs = (ctypes.c_void_p * 3)(keys.data_ptr(), ys.data_ptr(),
                                 fin.data_ptr())
    with torch.cuda.device(dev):
        err = lib.tp_frame_launch(
            f_loc.data_ptr(), f_loc.stride(0), lo, f_last.data_ptr(),
            f_blank.data_ptr(), None, None, state.data_ptr(), 1, None, None,
            None, 1, 1, lo, hi, outs, 1, B, W, V, blank_id, _lib.stream(dev))
    _lib.check(err, "tp_frame")
    global tp_frame_launches
    tp_frame_launches += 1
    return ys, keys, fin


def tp_merge_plain(keys, ys, fins) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels' merge: the m lists keys [m, B, W]
    (`rank_keys`), ys [m, B, W], fins [m, NF, B, W] -> (the global beam
    [NF, B, W], its ys [B, W]): the W largest keys of their union (JAX's
    all_gather + global top-W, `decode_tp.py:262-284`)."""
    m, B, W = keys.shape
    sel = torch.sort(keys.permute(1, 0, 2).reshape(B, m * W), dim=1,
                     descending=True).indices[:, :W]
    fin = fins.permute(1, 2, 0, 3).reshape(fins.shape[1], B, m * W)
    return (torch.gather(fin, 2, sel.expand(fin.shape[0], -1, -1)),
            torch.gather(ys.permute(1, 0, 2).reshape(B, m * W), 1, sel))


def tp_frame_merged_plain(f, keys, ys, fins, lo: int, hi: int, V: int,
                          blank_id: int = 0):
    """Plain version of the frame kernel of `tp_frames`: merge the
    previous frame's m lists (`tp_merge_plain`; keys None: fins[0] is the
    state), then `tp_frame_plain` on the window [lo, hi) of the full rows
    f [B, V]. Returns (the merged ys [B, W], or None without input keys;
    the shard's (ys, keys, fin))."""
    if keys is None:
        st, ys_prev = fins[0], None
    else:
        st, ys_prev = tp_merge_plain(keys, ys, fins)
    last = st[FIELDS.index("last")].long().clamp(0, V - 1)
    return ys_prev, tp_frame_plain(f[:, lo:hi], torch.gather(f, 1, last),
                                   f[:, blank_id].contiguous(), st, lo, hi,
                                   V, blank_id)


def tp_frames_plain(log_probs: torch.Tensor, init: torch.Tensor, n: int,
                    blank_id: int = 0):
    """Plain version of `tp_frames` on log_probs' device: every frame,
    every shard with a window merges the previous frame's lists and runs
    its frame (`tp_frame_merged_plain`); a shard with an empty window (n >
    V) has no candidate and sits out; a closing merge. Returns (final
    packed state [NF, B, W], ys [T, B, W])."""
    T, B, V = log_probs.shape
    W = init.shape[2]
    dev = log_probs.device
    ys = torch.empty(T, B, W, dtype=torch.int32, device=dev)
    lists = (None, None, init.to(dev)[None])
    bounds = [b for b in shard_bounds(V, n) if b[0] < b[1]]
    for t in range(T):
        outs = [tp_frame_merged_plain(log_probs[t], *lists, lo, hi, V,
                                      blank_id) for lo, hi in bounds]
        if t > 0:
            ys[t - 1] = outs[0][0]
        lists = tuple(torch.stack([o[1][i] for o in outs]) for i in (1, 0, 2))
    if T == 0:
        return lists[2][0].clone(), ys
    st, ys[T - 1] = tp_merge_plain(*lists)
    return st, ys


def enable_peers(cards) -> None:
    """Let every card of `cards` read and write the others' memory."""
    lib = _lib.load("decode_tp")
    for d in cards:
        with torch.cuda.device(d):
            for e in cards:
                if e != d:
                    _lib.check(lib.enable_peer_access(e.index),
                               f"peer access {d} -> {e}")


def push_inboxes(devices, G: int, words: int):
    """The push exchange's inboxes: shard s's [2, G, n, words] zeroed
    int64 words on its card, zeroed on every card before anything later
    on any card's stream (peers write them), with peer access enabled
    where the group spans cards."""
    n = len(devices)
    inbox = [torch.zeros(2, G, n, words, dtype=torch.int64, device=d)
             for d in devices]
    cards = list(dict.fromkeys(devices))
    if len(cards) > 1:
        enable_peers(cards)
        ready = {}
        for d in cards:
            with torch.cuda.device(d):
                ready[d] = torch.cuda.Event()
                ready[d].record()
        for d in cards:
            for e in cards:
                torch.cuda.current_stream(d).wait_event(ready[e])
    return inbox


def _cuda_group(log_probs: torch.Tensor, init: torch.Tensor, devices,
                what: str):
    """Checks of the TP kernels' inputs -> (devices, T, B, V, W)."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices} | {log_probs.device.type}
    if kinds != {"cuda"}:
        raise ValueError(f"{what}: the shards' devices {devices} and "
                         f"log_probs on {log_probs.device} must all be CUDA "
                         f"or all be the CPU")
    if log_probs.ndim != 3 or log_probs.dtype != torch.float32:
        raise ValueError(f"{what}: log_probs must be float32 [T, B, V]")
    T, B, V = log_probs.shape
    if init.ndim != 3 or init.shape[:2] != (len(FIELDS), B) or \
            init.dtype != torch.int32:
        raise ValueError(f"{what}: init must be int32 [NF, {B}, W]")
    return devices, T, B, V, init.shape[2]


def tp_frames(log_probs: torch.Tensor, init: torch.Tensor,
              devices: Sequence[torch.device], blank_id: int = 0):
    """The vocab-sharded scan frame by frame ("fused_frame") of the group
    whose shards sit on `devices` (in model-axis order; a device may
    repeat). log_probs [T, B, V] float32, init [NF, B, W] int32 packed.
    Returns (final packed state [NF, B, W], ys [T, B, W]) on the first
    shard's device, bit-equal to `fused_prefix_decode`'s.

    On CUDA tensors: one tp_frame launch a card a frame (grid B x the
    card's shards), each merging the previous frame's lists from a
    [2, n, ...] parity buffer on its card, reading its frame row and
    writing its lists into every card's buffer; then one merge-only launch
    for the final state and the last frame's ys. Everything is allocated
    before the loop, which issues only those launches and, across cards,
    an event record a card a frame and the other cards' waits on it
    (peer writes land before the next frame reads them; the host orders,
    no kernel spins). Envelope: W <= 128, n <= V, ceil(V/n) <= 128 (JAX's
    `frame_ok`), at most 8 cards. On CPU tensors: `tp_frames_plain`."""
    if {torch.device(d).type for d in devices} | {log_probs.device.type} \
            == {"cpu"}:
        return tp_frames_plain(log_probs, init, len(devices), blank_id)
    devices, T, B, V, W = _cuda_group(log_probs, init, devices, "tp_frames")
    n = len(devices)
    if W < 1 or not tp_envelope(W, V, n, scan=False):
        raise ValueError(f"tp_frames: W={W}, V={V}, n={n} is outside the "
                         f"kernel's envelope (W <= 128, n <= V, ceil(V/n) "
                         f"<= {TP_MAX_WINDOW})")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} out of range for V={V}")
    cards = list(dict.fromkeys(devices))          # in first-shard order
    if len(cards) > TP_MAX_CARDS:
        raise ValueError(f"tp_frames: {len(cards)} cards; a launch writes "
                         f"its lists to at most {TP_MAX_CARDS}")
    dev0 = devices[0]
    ys = torch.empty(T, B, W, dtype=torch.int32, device=dev0)
    fin = torch.empty(len(FIELDS), B, W, dtype=torch.int32, device=dev0)
    if T * B == 0:
        fin.copy_(init)
        return fin, ys
    lib = _lib.load("decode_tp")
    if len(cards) > 1:
        enable_peers(cards)
    NF = len(FIELDS)
    lp = {d: log_probs.to(d).contiguous() for d in cards}
    st0 = {d: init.to(d).contiguous() for d in cards}
    shards = {d: torch.tensor([s for s in range(n) if devices[s] == d],
                              dtype=torch.int32, device=d) for d in cards}
    buf = {d: (torch.empty(2, n, B, W, dtype=torch.int64, device=d),
               torch.empty(2, n, B, W, dtype=torch.int32, device=d),
               torch.empty(2, n, NF, B, W, dtype=torch.int32, device=d))
           for d in cards}
    outs = [(ctypes.c_void_p * (3 * len(cards)))(
        *[t[par].data_ptr() for d in cards for t in buf[d]])
        for par in (0, 1)]
    streams = {d: torch.cuda.current_stream(d) for d in cards}
    events = {d: torch.cuda.Event() for d in cards}
    row = B * V * 4                                 # bytes a frame
    ys_row = B * W * 4
    fixed = {d: (shards[d].data_ptr(), len(shards[d]), n, 0, 0)
             for d in cards}
    tail = (B, W, V, blank_id)
    global tp_frame_launches
    for t in range(T):
        for d in cards:
            if t == 0:
                ins = (None, None, st0[d].data_ptr(), 1)
            else:
                k_in, y_in, f_in = (x[(t - 1) & 1] for x in buf[d])
                ins = (k_in.data_ptr(), y_in.data_ptr(), f_in.data_ptr(), n)
            ys_merged = ys.data_ptr() + (t - 1) * ys_row \
                if t > 0 and d == dev0 else None
            with torch.cuda.device(d):
                err = lib.tp_frame_launch(
                    lp[d].data_ptr() + t * row, V, 0, None, None, *ins,
                    ys_merged, None, *fixed[d], outs[t & 1], len(cards),
                    *tail, ctypes.c_void_p(streams[d].cuda_stream))
            _lib.check(err, f"tp_frame (frame {t} on {d})")
            tp_frame_launches += 1
            if len(cards) > 1:
                events[d].record(streams[d])
        if len(cards) > 1:
            for d in cards:
                for e in cards:
                    if e != d:
                        streams[d].wait_event(events[e])
    k_in, y_in, f_in = (x[(T - 1) & 1] for x in buf[dev0])
    with torch.cuda.device(dev0):
        err = lib.tp_frame_launch(
            lp[dev0].data_ptr(), V, 0, None, None, k_in.data_ptr(),
            y_in.data_ptr(), f_in.data_ptr(), n,
            ys.data_ptr() + (T - 1) * ys_row, fin.data_ptr(), None, 1, n, 0,
            1, outs[0], 0, *tail, ctypes.c_void_p(streams[dev0].cuda_stream))
    _lib.check(err, "tp_frame (the closing merge)")
    tp_frame_launches += 1
    return fin, ys


def tp_envelope(W: int, V: int, n: int, scan: bool) -> bool:
    """JAX's `frame_ok` / `scan_ok` (`decode_tp.py:391-392`)."""
    ok = W <= 128 and n <= V and -(-V // n) <= TP_MAX_WINDOW
    return ok and (not scan or V <= TP_SCAN_MAX_V)


def tp_scan_plain(log_probs: torch.Tensor, init: torch.Tensor, n: int,
                  blank_id: int = 0):
    """Plain version: `tp_frames_plain`, every shard's final state the
    merged one. Returns (fins [n, NF, B, W], ys [T, B, W]) like
    `tp_scan`."""
    fin, ys = tp_frames_plain(log_probs, init, n, blank_id)
    return fin.unsqueeze(0).expand(n, -1, -1, -1).contiguous(), ys


def pick_design(n: int, cards: int, W: int, V: int,
                cluster_limit: int = TP_CLUSTER_PORTABLE) -> str:
    """`tp_scan`'s design for n shards on `cards` cards: "cluster" where
    every shard sits on one card and n <= min(TP_CLUSTER_PICK,
    cluster_limit) (cluster_limit: the largest cluster of the kernel the
    card holds, `tp_cluster_limit`; 8 blocks portably, up to 16), "push"
    otherwise. Raises where no design admits the shape: outside JAX's
    `scan_ok` (W <= 128, n <= V <= 256, ceil(V/n) <= 128), or more cards
    than shards. `tp_scan(design="cluster")` takes the cluster design up to
    cluster_limit."""
    if n < 1 or cards < 1 or cards > n:
        raise ValueError(f"tp_scan: {n} shards on {cards} cards")
    if W < 1 or not tp_envelope(W, V, n, scan=True):
        raise ValueError(f"tp_scan: W={W}, V={V}, n={n} is outside the "
                         f"kernel's envelope (W <= 128, n <= V <= 256, "
                         f"ceil(V/n) <= 128)")
    if cards == 1 and n <= min(cluster_limit, TP_CLUSTER_PICK):
        return "cluster"
    return "push"


_cluster_limits = {}


def tp_cluster_limit(device, W: int, V: int) -> int:
    """The largest cluster (at most 16 blocks) of tp_scan's cluster design
    at n = its size that `device` holds at least once."""
    dev = torch.device(device)
    key = (dev.index, W, V)
    if key not in _cluster_limits:
        c = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _lib.check(_lib.load("decode_tp").tp_scan_cluster_limit(
                W, V, ctypes.byref(c)), "tp_scan_cluster_limit")
        _cluster_limits[key] = c.value
    return _cluster_limits[key]


def _pointer_table(tensors, dev) -> torch.Tensor:
    return torch.tensor([t.data_ptr() for t in tensors], dtype=torch.int64,
                        device=dev)


def tp_scan(log_probs: torch.Tensor, init: torch.Tensor,
            devices: Sequence[torch.device], blank_id: int = 0,
            design: str = None):
    """The whole vocab-sharded scan of one model group.

    log_probs [T, B, V] float32 (replicated onto every shard's device);
    init [NF, B, W] int32 packed; devices: the group's shards in
    model-axis order (a device may repeat: several shards on one card).
    Returns (fins [n, NF, B, W], ys [T, B, W]) on the first shard's
    device: every shard's final packed beam (equal on every shard) and the
    packed backpointers, bit-equal to `fused_prefix_decode`'s.

    On CUDA tensors the design is `pick_design`'s (or `design`, which the
    placement must admit): "cluster", one launch of clusters of n blocks
    on the one card (as many as it holds at once, each walking
    utterances; n up to `tp_cluster_limit`); "push", one cooperative
    launch per card that holds shards, each card's shards x G blocks (G:
    as many as every card holds at once, at most B), all issued before
    any synchronisation, shards on other cards reached through peer
    pointers; a grid that cannot be resident at once raises, never runs.
    Envelope: W <= 128, n <= V <= 256, ceil(V/n) <= 128 (JAX's
    `scan_ok`)."""
    n = len(devices)
    if {torch.device(d).type for d in devices} | {log_probs.device.type} \
            == {"cpu"}:
        return tp_scan_plain(log_probs, init, n, blank_id)
    devices, T, B, V, W = _cuda_group(log_probs, init, devices, "tp_scan")
    cards = list(dict.fromkeys(devices))          # in first-shard order
    dev0 = devices[0]
    limit = tp_cluster_limit(dev0, W, V) \
        if len(cards) == 1 and 1 <= W <= 128 else 0
    picked = pick_design(n, len(cards), W, V, limit)
    if design is None:
        design = picked
    elif design not in TP_DESIGNS or (design == "cluster" and (
            len(cards) > 1 or n > limit)):
        raise ValueError(f"tp_scan: design {design!r} does not admit {n} "
                         f"shards on {len(cards)} card(s) (cluster limit "
                         f"{limit}); {picked!r} does")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} out of range for V={V}")
    fins = torch.empty(n, len(FIELDS), B, W, dtype=torch.int32, device=dev0)
    ys = torch.empty(T, B, W, dtype=torch.int32, device=dev0)
    if T * B == 0:
        fins[:] = init.to(dev0)
        return fins, ys
    lib = _lib.load("decode_tp")
    global tp_scan_launches
    if design == "cluster":
        lp = log_probs.to(dev0).contiguous()
        init_d = init.to(dev0).contiguous()
        with torch.cuda.device(dev0):
            err = lib.tp_scan_cluster_launch(
                lp.data_ptr(), init_d.data_ptr(), T, B, W, V, blank_id, n,
                ys.data_ptr(), fins.data_ptr(), _lib.stream(dev0))
        _lib.check(err, f"tp_scan ({B} clusters of {n} blocks on {dev0})")
        tp_scan_launches += 1
        return fins, ys
    local = {d: [s for s in range(n) if devices[s] == d] for d in cards}
    cap = {}
    for d in cards:
        c = ctypes.c_int(0)
        with torch.cuda.device(d):
            _lib.check(lib.tp_scan_push_capacity(W, V, n, ctypes.byref(c)),
                       "tp_scan_push_capacity")
        cap[d] = c.value
    G = min(B, min(cap[d] // len(local[d]) for d in cards))
    if G < 1:
        raise ValueError(
            f"tp_scan: {n} shards cannot be resident at once on "
            f"{[str(d) for d in cards]}, which hold {list(cap.values())} "
            f"blocks; the push exchange needs every block of a group "
            f"resident")
    inbox = push_inboxes(devices, G, 2 * W)
    args = []
    for d in cards:
        args.append((d, log_probs.to(d).contiguous(), init.to(d).contiguous(),
                     torch.tensor(local[d], dtype=torch.int32, device=d),
                     _pointer_table(inbox, d),
                     torch.empty(len(local[d]), len(FIELDS), B, W,
                                 dtype=torch.int32, device=d)))
    for d, lp_d, init_d, shards_d, box_d, fin_d in args:
        with torch.cuda.device(d):
            err = lib.tp_scan_push_launch(
                lp_d.data_ptr(), init_d.data_ptr(), T, B, W, V, blank_id, n,
                shards_d.data_ptr(), len(local[d]), G, box_d.data_ptr(),
                ys.data_ptr() if d == dev0 else None, fin_d.data_ptr(),
                _lib.stream(d))
        _lib.check(err, f"tp_scan ({len(local[d])} shards x {G} blocks on "
                        f"{d})")
        tp_scan_launches += 1
    if len(cards) > 1:
        # the inboxes go back to each card's allocator when this returns,
        # while peers on other cards may still write them
        for d in cards:
            torch.cuda.synchronize(d)
    for d, _, _, _, _, fin_d in args:
        for i, s in enumerate(local[d]):
            fins[s] = fin_d[i].to(dev0)
    return fins, ys
