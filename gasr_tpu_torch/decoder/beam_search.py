"""Batched CTC prefix beam search (log domain, matched merge) in PyTorch.

A port of `gasr_tpu/decoder/beam_search.py`'s "prefix" algorithm.
Per frame, each of the W beam slots offers one "stay" candidate (blank
transition, repeat collapse, and the extend absorbed from its parent
prefix) and V-1 "extend" candidates; the exact stable top-W of the
W x V grid becomes the next beam. Prefix identity is a pair of 32-bit
rolling hashes; tokens are not kept during the scan but rebuilt from
per-frame backpointers by a reverse walk.

This eager version is the plain PyTorch version of the CUDA decode and
traceback kernels (`ops/cuda/fused_decode.py`), expression for
expression: the same `_logaddexp` with its -80 clamp, the DEAD / NEG_INF
sentinels, the uint32 hashes (held in int64, masked to 32 bits), the
length folded into the parent-match key, and the top-W tie order of
`lax.top_k` (`ops/cuda/topk.py`).

merge_impl: "auto" and "pallas" take the CUDA kernels on CUDA tensors
(raising outside their envelope) and this eager scan on CPU tensors;
"matched" always runs this eager scan. Not ported yet (ROADMAP.md
Queue 1 item 8), each raising `NotImplementedError`: the "reference"
algorithm, `prob_domain`, merge_impl="sort", topk_impl="approx" and
`lm_bias`. Streaming (`streaming_init` / `streaming_step`) is not here
yet either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gasr_tpu_torch.ops.cuda.topk import topk_plain

NEG_INF = -1.0e30          # finite -inf stand-in (avoids nan arithmetic)
DEAD_KEY_LOG = -3.0e38     # top-W key of dead / excluded candidates
H_SEED = 2166136261
M1 = 1000003
M2 = 16777619
MASK32 = 0xFFFFFFFF


class BeamSearchResult(NamedTuple):
    tokens: torch.Tensor     # [B, W, max_len] int32, -1 padded
    lengths: torch.Tensor    # [B, W] int32 (true prefix length; may exceed
                             # max_len, then overflow is set and tokens
                             # hold the first max_len symbols)
    scores: torch.Tensor     # [B, W] float32 log(p)
    overflow: torch.Tensor   # [B, W] bool
    timesteps: torch.Tensor  # [B, W, max_len] int32 (-1 padded): frame at
                             # which the hypothesis first appended each token


class _BeamState(NamedTuple):
    h1: torch.Tensor         # [B, W] int64 holding uint32: prefix hash 1
    h2: torch.Tensor         # [B, W] prefix hash 2
    hp1: torch.Tensor        # [B, W] hash 1 of the prefix minus its last char
    hp2: torch.Tensor        # [B, W] hash 2 of the prefix minus its last char
    last: torch.Tensor       # [B, W] int32 last char (-1 if empty)
    length: torch.Tensor     # [B, W] int32 collapsed prefix length
    live: torch.Tensor       # [B, W] bool
    s1: torch.Tensor         # [B, W] float32 p_blank (log)
    s2: torch.Tensor         # [B, W] float32 p_nonblank (log)


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return m + torch.log1p(torch.exp(torch.clamp_min(lo - m, -80.0)) *
                           (lo - m > -80.0))


def _init_beam(B: int, W: int, device) -> _BeamState:
    slot = torch.arange(W, device=device)
    first = (slot == 0).expand(B, W)
    zeros64 = torch.zeros(B, W, dtype=torch.int64, device=device)
    return _BeamState(
        h1=torch.where(first, H_SEED, 0).to(torch.int64),
        h2=torch.where(first, H_SEED, slot.expand(B, W)).to(torch.int64),
        hp1=zeros64,
        hp2=zeros64.clone(),
        last=torch.full((B, W), -1, dtype=torch.int32, device=device),
        length=torch.zeros(B, W, dtype=torch.int32, device=device),
        live=first.clone(),
        s1=torch.where(first, 0.0, NEG_INF).to(torch.float32),
        s2=torch.full((B, W), NEG_INF, dtype=torch.float32, device=device),
    )


def _frame_step(state: _BeamState, f: torch.Tensor, blank_id: int):
    """One frame of the matched-merge prefix search. f: [B, V] log-probs.
    Returns (next state, packed backpointers [B, W] int32)."""
    B, W = state.s1.shape
    V = f.shape[1]
    dev = f.device
    pb, pnb, live = state.s1, state.s2, state.live
    last = state.last.long()
    length = state.length.long()
    total = _logaddexp(pb, pnb)                              # [B, W]
    last_clip = last.clamp(0, V - 1)
    f_last = torch.gather(f, 1, last_clip)                   # [B, W]

    # parent match: w (dim 1) is the candidate parent of stay slot w'
    # (dim 2), i.e. prefix_w + last_w' == prefix_w'. The length
    # off-by-one test is folded into the h2 key (k2 = 31*h2 + length).
    k2 = (state.h2 * 31 + length) & MASK32
    kp2 = (state.hp2 * 31 + (length - 1)) & MASK32
    eq = ((state.h1[:, :, None] == state.hp1[:, None, :])
          & (k2[:, :, None] == kp2[:, None, :])
          & live[:, :, None] & live[:, None, :])             # [B, W, W']
    has_match = eq.any(dim=1)                                # [B, W']
    match = eq.to(torch.int32).argmax(dim=1)                 # first True

    # stay candidates (the blank column)
    stay_pb = total + f[:, blank_id:blank_id + 1]
    stay_pnb = torch.where(length > 0, pnb + f_last, NEG_INF)
    pb_m = torch.gather(pb, 1, match)
    pnb_m = torch.gather(pnb, 1, match)
    last_m = torch.gather(last, 1, match)
    ext_base_m = torch.where(last_m == last, pb_m, _logaddexp(pb_m, pnb_m))
    ext_contrib = torch.where(has_match, ext_base_m + f_last, NEG_INF)
    stay_pnb = _logaddexp(stay_pnb, ext_contrib)
    stay_score = torch.where(live, _logaddexp(stay_pb, stay_pnb),
                             DEAD_KEY_LOG)

    # extend candidates [B, W, V]; an extend whose prefix already sits
    # in the beam (absorbed into that slot's stay) is excluded
    vs = torch.arange(V, device=dev)
    is_rep = vs[None, None, :] == last[:, :, None]
    ext_pnb = torch.where(is_rep, pb[:, :, None], total[:, :, None]) \
        + f[:, None, :]
    excl_idx = torch.where(has_match, match * V + last_clip, W * V)
    excl = torch.zeros(B, W * V + 1, dtype=torch.bool, device=dev)
    excl.scatter_(1, excl_idx, True)
    excl = excl[:, :W * V].view(B, W, V)
    valid_ext = (vs != blank_id)[None, None, :] & live[:, :, None] & ~excl
    ext_score = torch.where(valid_ext, ext_pnb, DEAD_KEY_LOG)
    cand = torch.where((vs == blank_id)[None, None, :],
                       stay_score[:, :, None], ext_score)

    top_vals, idx = topk_plain(cand.reshape(B, W * V), W)
    idx = idx.long()
    w_sel = idx // V
    v_sel = idx % V
    is_stay = v_sel == blank_id
    new_live = top_vals > DEAD_KEY_LOG * 0.5

    def g(x):
        return torch.gather(x, 1, w_sel)

    h1g, h2g, hp1g, hp2g = g(state.h1), g(state.h2), g(state.hp1), g(state.hp2)
    last_g, len_g = g(last), g(length)
    sel_ext_pnb = torch.gather(ext_pnb.reshape(B, W * V), 1, idx)
    ns1 = torch.where(new_live & is_stay, g(stay_pb), NEG_INF)
    ns2 = torch.where(new_live, torch.where(is_stay, g(stay_pnb),
                                            sel_ext_pnb), NEG_INF)
    vp1 = v_sel + 1
    n_last = torch.where(is_stay, last_g, v_sel)
    new_state = _BeamState(
        h1=torch.where(is_stay, h1g, (h1g * M1 + vp1) & MASK32),
        h2=torch.where(is_stay, h2g, (h2g * M2 + vp1) & MASK32),
        hp1=torch.where(is_stay, hp1g, h1g),
        hp2=torch.where(is_stay, hp2g, h2g),
        last=n_last.to(torch.int32),
        length=(len_g + (~is_stay).long()).to(torch.int32),
        live=new_live,
        s1=ns1, s2=ns2,
    )
    ys = _pack_ys(w_sel, n_last, (~is_stay) & new_live)
    return new_state, ys


def _matched_scan(log_probs: torch.Tensor, init: _BeamState, blank_id: int):
    """All T frames. Returns (final state, packed ys [T, B, W] int32)."""
    T = log_probs.shape[0]
    B, W = init.s1.shape
    ys = torch.empty(T, B, W, dtype=torch.int32, device=log_probs.device)
    state = init
    for t in range(T):
        state, ys[t] = _frame_step(state, log_probs[t], blank_id)
    return state, ys


def _pack_ys(parent, char, appended) -> torch.Tensor:
    """Backpointer fields -> one int32: parent | char<<15 | appended<<30."""
    return (parent.long() | (char.long().clamp_min(0) << 15)
            | (appended.long() << 30)).to(torch.int32)


def _unpack_ys(packed: torch.Tensor):
    packed = packed.long()
    return packed & 0x7FFF, (packed >> 15) & 0x7FFF, ((packed >> 30) & 1) > 0


def _traceback(packed_ys: torch.Tensor, final_lengths: torch.Tensor, L: int):
    """Reverse backpointer walk. packed_ys [T, B, W], final_lengths [B, W].
    Emissions commit at position pos-1; positions < 0 or >= L are dropped
    (head-keeping on overflow). Returns (tokens [B, W, L], timesteps
    [B, W, L], start_parent [B, W]), -1 where nothing was emitted."""
    T, B, W = packed_ys.shape
    dev = packed_ys.device
    cur = torch.arange(W, device=dev).expand(B, W).contiguous()
    pos = final_lengths.long()
    buf_tok = torch.full((B, W, L + 1), -1, dtype=torch.int32, device=dev)
    buf_ts = torch.full((B, W, L + 1), -1, dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        p, c, a = _unpack_ys(torch.gather(packed_ys[t].long(), 1, cur))
        emit = torch.where(a, torch.clamp_max(pos - 1, L), L)
        emit = torch.where(emit < 0, L, emit)[:, :, None]
        buf_tok.scatter_(2, emit, torch.where(a, c, -1).to(torch.int32)
                         [:, :, None])
        buf_ts.scatter_(2, emit, torch.where(a, t, -1).to(torch.int32)
                        [:, :, None])
        cur = p
        pos = torch.where(a, pos - 1, pos)
    return buf_tok[:, :, :L], buf_ts[:, :, :L], cur.to(torch.int32)


def _result(final: _BeamState, tokens, timesteps, L: int) -> BeamSearchResult:
    scores = torch.where(final.live, _logaddexp(final.s1, final.s2), NEG_INF)
    lengths = torch.where(final.live, final.length, 0).to(torch.int32)
    overflow = (lengths > L) & final.live
    return BeamSearchResult(tokens=tokens, lengths=lengths, scores=scores,
                            overflow=overflow, timesteps=timesteps)


def ctc_beam_search(
    log_probs: torch.Tensor,
    beam_width: int,
    blank_id: int = 0,
    max_len: int = 256,
    algorithm: str = "prefix",
    prob_domain: bool = False,
    merge_impl: str = "auto",
    topk_impl: str = "exact",
    input_lengths: Optional[torch.Tensor] = None,
    lm_bias: Optional[torch.Tensor] = None,
) -> BeamSearchResult:
    """Batched CTC prefix beam search on [T, B, V] time-major log-probs.

    Returns a BeamSearchResult with the beams sorted best-first per
    example; tokens are collapsed symbol ids (never blank), -1 padded.

    merge_impl: "auto" / "pallas" (the CUDA kernels on CUDA tensors,
    raising outside W <= 128 and W*V <= 16384; the eager scan on CPU
    tensors) or "matched" (the eager scan on any device).
    input_lengths: [B] per-utterance frame counts; frames at t >= length
    become a certain blank, which leaves every prefix's probability
    (transcripts and scores) unchanged.
    """
    if algorithm == "reference" or prob_domain:
        raise NotImplementedError(
            "the 'reference' algorithm and prob_domain are not ported yet "
            "(ROADMAP.md Queue 1 item 8)")
    if algorithm != "prefix":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if merge_impl == "sort":
        raise NotImplementedError(
            "merge_impl='sort' is not ported yet (ROADMAP.md Queue 1 item 8)")
    if merge_impl not in ("auto", "matched", "pallas"):
        raise ValueError(f"unknown merge_impl {merge_impl!r}")
    if topk_impl != "exact":
        raise NotImplementedError(
            f"topk_impl={topk_impl!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 8); only 'exact'")
    if lm_bias is not None:
        raise NotImplementedError(
            "lm_bias shallow fusion is not ported yet (ROADMAP.md Queue 1 "
            "item 8)")
    if log_probs.ndim != 3 or log_probs.dtype != torch.float32:
        raise ValueError("log_probs must be float32 [T, B, V]")

    T, B, V = log_probs.shape
    W, L = beam_width, max_len
    if input_lengths is not None:
        t_idx = torch.arange(T, device=log_probs.device)[:, None]
        pad = t_idx >= input_lengths.to(log_probs.device)[None, :]
        onehot_blank = torch.where(
            torch.arange(V, device=log_probs.device) == blank_id, 0.0,
            NEG_INF)
        log_probs = torch.where(pad[:, :, None], onehot_blank[None, None, :],
                                log_probs)

    init = _init_beam(B, W, log_probs.device)
    if merge_impl == "matched":
        final, packed_ys = _matched_scan(log_probs, init, blank_id)
        tokens, timesteps, _ = _traceback(packed_ys, final.length, L)
    else:
        from gasr_tpu_torch.ops.cuda import fused_decode
        final, packed_ys = fused_decode.fused_prefix_decode(
            log_probs, init, blank_id)
        tokens, timesteps, _ = fused_decode.traceback(packed_ys,
                                                      final.length, L)
    return _result(final, tokens, timesteps, L)


def decode_to_lists(result: BeamSearchResult, top: int = 1):
    """Host-side: result -> list (per example) of (token_list, score)."""
    tokens = result.tokens.cpu().numpy()
    lengths = result.lengths.cpu().numpy()
    scores = result.scores.cpu().numpy()
    L = tokens.shape[2]
    out = []
    for b in range(tokens.shape[0]):
        beams = []
        for w in range(min(top, tokens.shape[1])):
            n = min(int(lengths[b, w]), L)
            beams.append((tokens[b, w, :n].tolist(), float(scores[b, w])))
        out.append(beams if top > 1 else beams[0])
    return out

