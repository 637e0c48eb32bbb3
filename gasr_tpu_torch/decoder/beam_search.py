"""Batched CTC beam search in PyTorch: the "prefix" and "reference"
algorithms, and streaming decode.

A port of `gasr_tpu/decoder/beam_search.py`. Two algorithms:
  - "prefix": CTC prefix beam search in the log domain, (p_blank,
    p_nonblank) per collapsed prefix;
  - "reference": the reference decoder's algorithm (blank-annotated
    paths, one score per hypothesis, merge by sum, prune after the
    merge, trailing-blank strip on the final frame), in the log domain
    or, with `prob_domain=True`, multiplying raw probabilities.
Prefix identity is a pair of 32-bit rolling hashes (held in int64,
masked to 32 bits); tokens are not kept during the scan but rebuilt
from per-frame backpointers by a reverse walk.

Two merges per frame:
  - the matched merge (`_frame_step`, prefix algorithm only): each of the
    W slots offers one "stay" candidate (blank transition, repeat
    collapse and the extend absorbed from its parent prefix) and V-1
    extends; the exact stable top-W of the W x V grid is the next beam.
    It is the plain version of the CUDA decode kernel
    (`ops/cuda/fused_decode.py`), expression for expression;
  - the sort merge (`_make_frame_step`, both algorithms): all W*V
    candidates sorted by (h1, h2, flag) with stable sorts, equal runs
    merged by log-sum-exp (or sum), then the top-W. `lax.sort(num_keys=3,
    is_stable=True)` becomes two stable `torch.sort` passes, last key
    first; `segment_max` / `segment_sum` become `scatter_reduce` /
    `index_add_`.
Every top-W uses `topk_plain`, so ties fall in `lax.top_k`'s order.

merge_impl: "auto" takes the CUDA kernels on CUDA tensors where JAX's
`_use_pallas` shape rule holds (W <= 128 and V <= 128, or W <= 64 and
V <= 256, and V <= 255 with `lm_bias`; prefix algorithm, log domain) and
the matched scan otherwise, or the sort merge for "reference"; "pallas"
asks for the kernels and raises where that rule fails (CPU tensors run
their plain versions); "matched" and "sort" always run the eager scan.
Past the decode kernel's shape rule, "auto" on a CUDA tensor (prefix,
log domain, no `lm_bias`) runs the vocab-sharded frame kernel
(`ops/cuda/fused_decode.py::tp_frames`, the "fused_frame" route of
`parallel/decode_tp.py`) with the vocabulary split over
n = ceil(V / 128) shards of the one card, then the traceback kernel:
one launch a frame and a closing merge, bit-equal to the matched scan,
for any V with W <= 128 (`_use_vocab_shards`).

lm_bias: bigram shallow fusion, a [V+1, V] table (`decoder/lm.py`) added
to every extend's score, row = previous char + 1 (row 0 = the empty
prefix). It is quantized to bfloat16 once and handed, as float32, to the
decode kernel or to the matched scan alike (JAX's contract,
`gasr_tpu/decoder/beam_search.py:703-710`); the matched merge only.

topk_impl: "exact" takes each frame's top-W by `lax.top_k`; "approx" by
`lax.approx_max_k(..., recall_target=0.99)` in JAX's matched step
(`gasr_tpu/decoder/beam_search.py:376-383`). Off the TPU that is XLA's
sort-and-slice fallback, which at k < n (the decoder's k = W, n = W*V)
returns `lax.top_k`'s indices bit for bit, +0.0 above -0.0 included
(measured with jax 0.9.0 on the CPU, tests/test_torch_approx.py): the
same selection, so "approx" takes the same top-W here and in the decode
kernel. It needs the matched merge and raises where JAX raises
(`_pick_step`, `_use_kernels`). `ctc_beam_search` only: `streaming_step`
takes no topk_impl, as JAX's does not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gasr_tpu_torch.config import resolve_device
from gasr_tpu_torch.ops.cuda.topk import topk_plain
from gasr_tpu_torch.runtime.profiler import span

NEG_INF = -1.0e30          # finite -inf stand-in (avoids nan arithmetic)
DEAD_KEY_LOG = -3.0e38     # top-W key of dead / excluded candidates
DEAD_KEY_PROB = -1.0       # ... in the prob domain (below any prob >= 0)
H_SEED = 2166136261
M1 = 1000003
M2 = 16777619
MASK32 = 0xFFFFFFFF


class BeamSearchResult(NamedTuple):
    tokens: torch.Tensor     # [B, W, max_len] int32, -1 padded
    lengths: torch.Tensor    # [B, W] int32 (true prefix length; may exceed
                             # max_len, then overflow is set and tokens
                             # hold the first max_len symbols)
    scores: torch.Tensor     # [B, W] float32: log(p), or the summed prob
                             # ("reference" with prob_domain)
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
    tb: torch.Tensor         # [B, W] int32 trailing-blank flag ("reference";
                             # 0 on the prefix paths and in the kernel)
    live: torch.Tensor       # [B, W] bool
    s1: torch.Tensor         # [B, W] float32: p_blank (prefix) | score
    s2: torch.Tensor         # [B, W] float32: p_nonblank (prefix) | unused


class StreamingState(NamedTuple):
    """Carried across chunks: the beam and the materialized prefixes.

    tokens / timesteps are always in the public layout [B, W, max_len].
    JAX's `meta` field and its [B, Lp, 128] kernel layout are left out:
    they place positions on sublanes and slots on lanes for the TPU's
    vector layout and mean nothing on the card. `frames` is a host int,
    so that advancing it and handing it to the kernel as the chunk's
    frame offset never reads a device scalar back.
    """
    beam: _BeamState
    tokens: torch.Tensor     # [B, W, max_len] int32
    timesteps: torch.Tensor  # [B, W, max_len] int32 (absolute frame index)
    frames: int              # frames consumed so far


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return m + torch.log1p(torch.exp(torch.clamp_min(lo - m, -80.0)) *
                           (lo - m > -80.0))


def _segment_logsumexp(s: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment log-sum-exp of s [n] over segment ids seg [n]."""
    m = torch.full((num_segments,), float("-inf"), dtype=s.dtype,
                   device=s.device).scatter_reduce(0, seg, s, "amax")
    mc = m[seg]
    contrib = torch.where(s - mc > -80.0,
                          torch.exp(torch.clamp_min(s - mc, -80.0)), 0.0)
    tot = torch.zeros_like(m).index_add_(0, seg, contrib)
    return torch.where(m > NEG_INF * 0.5,
                       m + torch.log(torch.clamp_min(tot, 1e-37)), NEG_INF)


def _merge_rows(k1, k2, k3, payload_scores, log_domain: bool):
    """Merge each row of N candidates by identity keys (k1, k2 uint32 in
    int64, k3 in 0..2), all rows at once. Returns (perm [B, N], first
    [B, N], merged scores aligned with the sorted order)."""
    B, N = k1.shape
    # stable sorts, last key first: (k2, k3) packed into one int64, then k1
    order = torch.sort(k2 * 4 + k3, dim=1, stable=True).indices
    perm = torch.gather(order, 1, torch.sort(
        torch.gather(k1, 1, order), dim=1, stable=True).indices)
    sk1, sk2, sk3 = (torch.gather(k, 1, perm) for k in (k1, k2, k3))
    first = torch.ones(B, N, dtype=torch.bool, device=k1.device)
    first[:, 1:] = ((sk1[:, 1:] != sk1[:, :-1]) | (sk2[:, 1:] != sk2[:, :-1])
                    | (sk3[:, 1:] != sk3[:, :-1]))
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    flat_seg = (seg + N * torch.arange(B, device=k1.device)[:, None]
                ).reshape(-1)
    merged = []
    for s in payload_scores:
        ss = torch.gather(s, 1, perm).reshape(-1)
        if log_domain:
            mseg = _segment_logsumexp(ss, flat_seg, B * N)
        else:
            mseg = torch.zeros_like(ss).index_add_(0, flat_seg, ss)
        merged.append(mseg[flat_seg].view(B, N))
    return perm, first, merged


def _init_beam(B: int, W: int, device, log_domain: bool = True
               ) -> _BeamState:
    slot = torch.arange(W, device=device)
    first = (slot == 0).expand(B, W)
    zeros64 = torch.zeros(B, W, dtype=torch.int64, device=device)
    zeros32 = torch.zeros(B, W, dtype=torch.int32, device=device)
    null_score = NEG_INF if log_domain else 0.0
    return _BeamState(
        h1=torch.where(first, H_SEED, 0).to(torch.int64),
        h2=torch.where(first, H_SEED, slot.expand(B, W)).to(torch.int64),
        hp1=zeros64,
        hp2=zeros64.clone(),
        last=torch.full((B, W), -1, dtype=torch.int32, device=device),
        length=zeros32,
        tb=zeros32.clone(),
        live=first.clone(),
        s1=torch.where(first, 0.0 if log_domain else 1.0,
                       null_score).to(torch.float32),
        s2=torch.full((B, W), null_score, dtype=torch.float32,
                      device=device),
    )


def _frame_step(state: _BeamState, f: torch.Tensor, blank_id: int,
                lm_q: Optional[torch.Tensor] = None):
    """One frame of the matched-merge prefix search. f: [B, V] log-probs;
    lm_q: the quantized [V+1, V] shallow-fusion table or None.
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
    if lm_q is not None:
        # + lm[last + 1, v] on every extend (not on the absorbed extend's
        # contribution to a stay). Dead slots' rows are clamped into the
        # table; their candidates are DEAD, so the value is never used.
        ext_pnb = ext_pnb + lm_q[(last + 1).clamp(0, V)]
    excl_idx = torch.where(has_match, match * V + last_clip, W * V)
    excl = torch.zeros(B, W * V + 1, dtype=torch.bool, device=dev)
    excl.scatter_(1, excl_idx, True)
    excl = excl[:, :W * V].view(B, W, V)
    valid_ext = (vs != blank_id)[None, None, :] & live[:, :, None] & ~excl
    ext_score = torch.where(valid_ext, ext_pnb, DEAD_KEY_LOG)
    cand = torch.where((vs == blank_id)[None, None, :],
                       stay_score[:, :, None], ext_score)

    # lax.top_k's order, which is also lax.approx_max_k's at k = W < W*V
    # (topk_impl="approx"; see the module docstring)
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
        tb=torch.zeros_like(state.length),
        live=new_live,
        s1=ns1, s2=ns2,
    )
    ys = _pack_ys(w_sel, n_last, (~is_stay) & new_live)
    return new_state, ys


def _make_frame_step(blank_id: int, algorithm: str, log_domain: bool):
    """The sort-merge frame step (JAX `_make_frame_step`):
    (state, f [B, V], is_last) -> (state', packed ys [B, W])."""
    dead_key = DEAD_KEY_LOG if log_domain else DEAD_KEY_PROB
    null_score = NEG_INF if log_domain else 0.0

    def frame_step(state: _BeamState, f: torch.Tensor, is_last: bool):
        B, W = state.s1.shape
        V = f.shape[1]
        N = W * V
        dev = f.device
        vs = torch.arange(V, device=dev)
        vb = (vs == blank_id)[None, None, :]
        v3 = vs[None, None, :]
        vp1 = (vs + 1)[None, None, :]
        h1, h2 = state.h1[:, :, None], state.h2[:, :, None]
        last = state.last.long()[:, :, None]
        length = state.length.long()[:, :, None]
        live = state.live[:, :, None]
        fv = f[:, None, :]                                   # [B, 1, V]

        if algorithm == "reference":
            collapse = (~vb) & (state.tb[:, :, None] == 0) & (last == v3) \
                & (length > 0)
            append = ((~vb) & (~collapse)).expand(B, W, V)
            new_tb = (vb & (not is_last)).to(torch.int32).expand(B, W, V)
            c_s1 = (state.s1[:, :, None] + fv if log_domain
                    else state.s1[:, :, None] * fv)
            c_s2 = torch.full((B, W, V), null_score, dtype=torch.float32,
                              device=dev)
        else:
            # "stay" candidates occupy the blank column: blank transition
            # plus the collapse (repeat) contribution
            total = _logaddexp(state.s1, state.s2)[:, :, None]
            f_last = torch.gather(f, 1, state.last.long().clamp(0, V - 1)
                                  )[:, :, None]
            stay_pb = total + fv
            stay_pnb = state.s2[:, :, None] + f_last
            ext_pnb = torch.where(last == v3, state.s1[:, :, None],
                                  total) + fv
            c_s1 = torch.where(vb, stay_pb, NEG_INF)
            c_s2 = torch.where(vb, stay_pnb, ext_pnb)
            append = (~vb).expand(B, W, V)
            new_tb = torch.zeros(B, W, V, dtype=torch.int32, device=dev)

        nh1 = torch.where(append, (h1 * M1 + vp1) & MASK32, h1)
        nh2 = torch.where(append, (h2 * M2 + vp1) & MASK32, h2)
        nhp1 = torch.where(append, h1, state.hp1[:, :, None])
        nhp2 = torch.where(append, h2, state.hp2[:, :, None])
        n_last = torch.where(append, v3, last)
        n_len = length + append.long()

        # identity flag: tb (0/1) for live, 2 for dead (disjoint keyspace)
        liveb = live.expand(B, W, V)
        flag = torch.where(liveb, new_tb, 2).long()
        cand_idx = torch.arange(N, device=dev).view(1, W, V)
        nh1 = torch.where(liveb, nh1, MASK32)
        nh2 = torch.where(liveb, nh2, cand_idx)
        c_s1 = torch.where(liveb, c_s1, null_score)
        c_s2 = torch.where(liveb, c_s2, null_score)
        parent = torch.arange(W, device=dev)[None, :, None].expand(B, W, V)

        def flat(x):
            return x.reshape(B, N)

        perm, first, merged = _merge_rows(flat(nh1), flat(nh2), flat(flag),
                                          (flat(c_s1), flat(c_s2)),
                                          log_domain)

        def g(x):                                # gather into sorted order
            return torch.gather(flat(x), 1, perm)

        live_s = g(liveb)
        rank = (merged[0] if algorithm == "reference"
                else _logaddexp(merged[0], merged[1]))
        topk_key = torch.where(first & live_s, rank, dead_key)
        _, idx_sel = topk_plain(topk_key, W)
        idx_sel = idx_sel.long()

        def sel(x_sorted):
            return torch.gather(x_sorted, 1, idx_sel)

        new_live = sel(first & live_s)
        new_state = _BeamState(
            h1=sel(g(nh1)), h2=sel(g(nh2)),
            hp1=sel(g(nhp1)), hp2=sel(g(nhp2)),
            last=sel(g(n_last)).to(torch.int32),
            length=sel(g(n_len)).to(torch.int32),
            tb=sel(g(new_tb)),
            live=new_live,
            s1=torch.where(new_live, sel(merged[0]), null_score),
            s2=torch.where(new_live, sel(merged[1]), null_score),
        )
        ys = _pack_ys(sel(g(parent)), sel(g(n_last)), sel(g(append)))
        return new_state, ys

    return frame_step


def _pick_step(blank_id: int, algorithm: str, log_domain: bool,
               merge_impl: str, lm_q: Optional[torch.Tensor] = None,
               topk_impl: str = "exact"):
    """The eager frame step for merge_impl ("pallas" here means its plain
    version, the matched step): (state, f, is_last) -> (state', ys).
    Raises as JAX's `_pick_step`, in its order of checks."""
    matched = algorithm == "prefix" and log_domain and merge_impl != "sort"
    if merge_impl == "matched" and not matched:
        raise ValueError("matched merge requires algorithm='prefix'")
    if lm_q is not None and not matched:
        raise ValueError("lm_bias requires the matched-merge prefix path")
    if matched:
        return lambda state, f, is_last: _frame_step(state, f, blank_id,
                                                     lm_q)
    if topk_impl != "exact":
        raise ValueError("approx top-k requires the matched-merge path")
    return _make_frame_step(blank_id, algorithm, log_domain)


def _scan(log_probs: torch.Tensor, init: _BeamState, step,
          last_frame: bool = False):
    """All T frames of `step`; `last_frame` marks frame T-1 as final.
    Returns (final state, packed ys [T, B, W] int32)."""
    T = log_probs.shape[0]
    B, W = init.s1.shape
    ys = torch.empty(T, B, W, dtype=torch.int32, device=log_probs.device)
    state = init
    for t in range(T):
        state, ys[t] = step(state, log_probs[t], last_frame and t == T - 1)
    return state, ys


def _matched_scan(log_probs: torch.Tensor, init: _BeamState, blank_id: int,
                  lm_q: Optional[torch.Tensor] = None):
    """The matched-merge scan: the plain version of the decode kernel."""
    return _scan(log_probs, init,
                 lambda state, f, _: _frame_step(state, f, blank_id, lm_q))


def _pack_ys(parent, char, appended) -> torch.Tensor:
    """Backpointer fields -> one int32: parent | char<<15 | appended<<30."""
    return (parent.long() | (char.long().clamp_min(0) << 15)
            | (appended.long() << 30)).to(torch.int32)


def _unpack_ys(packed: torch.Tensor):
    packed = packed.long()
    return packed & 0x7FFF, (packed >> 15) & 0x7FFF, ((packed >> 30) & 1) > 0


def _traceback(packed_ys: torch.Tensor, final_lengths: torch.Tensor, L: int,
               base_tokens: Optional[torch.Tensor] = None,
               base_timesteps: Optional[torch.Tensor] = None,
               t_offset: int = 0):
    """Reverse backpointer walk. packed_ys [Tc, B, W], final_lengths
    [B, W] (absolute prefix lengths at the end of the chunk). Emissions
    commit at position pos-1 with timestep t + t_offset; positions < 0
    or >= L are dropped (head-keeping on overflow). base_tokens /
    base_timesteps [B, W, L] are the prefixes at chunk start (None for a
    fresh decode): row start_parent of the base fills every position the
    walk did not write. Returns (tokens [B, W, L], timesteps [B, W, L],
    start_parent [B, W]), -1 where nothing was emitted."""
    Tc, B, W = packed_ys.shape
    dev = packed_ys.device
    cur = torch.arange(W, device=dev).expand(B, W).contiguous()
    pos = final_lengths.long()
    buf_tok = torch.full((B, W, L + 1), -1, dtype=torch.int32, device=dev)
    buf_ts = torch.full((B, W, L + 1), -1, dtype=torch.int32, device=dev)
    for t in range(Tc - 1, -1, -1):
        p, c, a = _unpack_ys(torch.gather(packed_ys[t].long(), 1, cur))
        emit = torch.where(a, torch.clamp_max(pos - 1, L), L)
        emit = torch.where(emit < 0, L, emit)[:, :, None]
        buf_tok.scatter_(2, emit, torch.where(a, c, -1).to(torch.int32)
                         [:, :, None])
        buf_ts.scatter_(2, emit, torch.where(a, t + t_offset, -1).to(
            torch.int32)[:, :, None])
        cur = p
        pos = torch.where(a, pos - 1, pos)
    tok, ts = buf_tok[:, :, :L], buf_ts[:, :, :L]
    if base_tokens is not None:
        # a chunk emission always writes token >= 0 and its timestep at the
        # same position; every other position keeps the start parent's row
        rows = cur[:, :, None].expand(B, W, L)
        emitted = tok >= 0
        tok = torch.where(emitted, tok, torch.gather(base_tokens, 1, rows))
        ts = torch.where(emitted, ts, torch.gather(base_timesteps, 1, rows))
    return tok.contiguous(), ts.contiguous(), cur.to(torch.int32)


def _result(final: _BeamState, tokens, timesteps, L: int,
            algorithm: str = "prefix", log_domain: bool = True
            ) -> BeamSearchResult:
    null_score = NEG_INF if log_domain else 0.0
    scores = (_logaddexp(final.s1, final.s2) if algorithm == "prefix"
              else final.s1)
    scores = torch.where(final.live, scores, null_score)
    lengths = torch.where(final.live, final.length, 0).to(torch.int32)
    overflow = (lengths > L) & final.live
    return BeamSearchResult(tokens=tokens, lengths=lengths, scores=scores,
                            overflow=overflow, timesteps=timesteps)


def _check_options(algorithm: str, prob_domain: bool, merge_impl: str,
                   topk_impl: str = "exact") -> None:
    if algorithm not in ("prefix", "reference"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if prob_domain and algorithm != "reference":
        raise ValueError("prob_domain is only for algorithm='reference'")
    if merge_impl not in ("auto", "matched", "sort", "pallas"):
        raise ValueError(f"unknown merge_impl {merge_impl!r}")
    if topk_impl not in ("exact", "approx"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}")


def _quantize_lm(lm_bias, V: int, device) -> Optional[torch.Tensor]:
    """The [V+1, V] table at bfloat16 resolution, as float32 on `device`;
    `+ 0.0` turns -0.0 into +0.0 (JAX `beam_search.py:703-710`)."""
    if lm_bias is None:
        return None
    lm = torch.as_tensor(lm_bias, dtype=torch.float32, device=device)
    if tuple(lm.shape) != (V + 1, V):
        raise ValueError(f"lm_bias must be [V+1, V] = [{V + 1}, {V}], got "
                         f"{list(lm.shape)}")
    return (lm.to(torch.bfloat16).to(torch.float32) + 0.0).contiguous()


def _use_kernels(merge_impl: str, algorithm: str, log_domain: bool, W: int,
                 V: int, device: torch.device, has_lm: bool = False,
                 topk_impl: str = "exact") -> bool:
    """JAX `_use_pallas`, decided by shape before any launch: "auto" takes
    the CUDA kernels for CUDA tensors where the shape rule holds;
    "pallas" raises where the request cannot be honoured, and takes the
    kernels' plain versions (the eager matched scan) for CPU tensors.

    One departure, by design: "auto" with topk_impl="approx" takes the
    kernels too, where JAX keeps approx off its kernel (Mosaic's
    selection is exact only). JAX's approx runs its matched scan, whose
    counterpart here is the eager scan, the decode kernel's plain
    version, ~80x slower on the card. Off the TPU `lax.approx_max_k`
    takes `lax.top_k`'s top-W (module docstring), which the kernel takes,
    so the results are those of JAX's route and only what runs differs.
    "pallas" with approx raises, as in JAX."""
    from gasr_tpu_torch.ops.cuda.fused_decode import in_envelope
    eligible = (algorithm == "prefix" and log_domain
                and in_envelope(W, V, has_lm))
    if merge_impl == "auto":
        return eligible and device.type == "cuda"
    if merge_impl != "pallas":
        return False
    if not (algorithm == "prefix" and log_domain):
        raise ValueError("merge_impl='pallas' requires the log-domain "
                         "prefix algorithm")
    if topk_impl != "exact":
        raise ValueError("merge_impl='pallas' is exact-top-k only")
    if has_lm and V > 255:
        raise ValueError("merge_impl='pallas' supports lm_bias only "
                         "for V <= 255; use merge_impl='matched'")
    if not eligible:
        raise ValueError("merge_impl='pallas' requires W <= 128 and "
                         "V <= 128, or W <= 64 and V <= 256")
    return device.type == "cuda"


def _use_vocab_shards(merge_impl: str, algorithm: str, log_domain: bool,
                      W: int, V: int, device: torch.device,
                      has_lm: bool = False) -> bool:
    """Whether "auto" runs the one-card vocab-sharded scan: a CUDA tensor
    outside the decode kernel's shape rule that the frame kernel takes
    (W <= 128, windows of at most 128 ids), prefix algorithm, log
    domain, no LM."""
    from gasr_tpu_torch.ops.cuda import fused_decode
    return (merge_impl == "auto" and device.type == "cuda"
            and algorithm == "prefix" and log_domain and not has_lm
            and not fused_decode.in_envelope(W, V)
            and fused_decode.tp_envelope(W, V, _vocab_shard_count(V),
                                         scan=False))


def _vocab_shard_count(V: int) -> int:
    from gasr_tpu_torch.ops.cuda.fused_decode import TP_MAX_WINDOW
    return -(-V // TP_MAX_WINDOW)


def _vocab_sharded_scan(log_probs: torch.Tensor, init: _BeamState,
                        blank_id: int) -> Tuple[_BeamState, torch.Tensor]:
    """The matched scan as `tp_frames` runs it with the vocabulary split
    over `_vocab_shard_count(V)` shards of log_probs' own device (the
    plain version on the CPU): (final state, packed ys [T, B, W]). Span:
    "decode.vocab_shards"."""
    from gasr_tpu_torch.ops.cuda import fused_decode
    n = _vocab_shard_count(log_probs.shape[2])
    with span("decode.vocab_shards"):
        fin, ys = fused_decode.tp_frames(
            log_probs, fused_decode.pack_state(init),
            [log_probs.device] * n, blank_id)
        return fused_decode.unpack_state(fin), ys


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
    """Batched CTC beam search on [T, B, V] time-major log-probs (raw
    probabilities for algorithm="reference" with prob_domain=True).

    Returns a BeamSearchResult with the beams sorted best-first per
    example; tokens are collapsed symbol ids (never blank), -1 padded.
    merge_impl, topk_impl: see the module docstring.
    input_lengths: [B] per-utterance frame counts (prefix algorithm, log
    domain); frames at t >= length become a certain blank, which leaves
    every prefix's probability (transcripts and scores) unchanged.
    lm_bias: optional [V+1, V] shallow-fusion table (see the module
    docstring).
    """
    with span("decode.search"):
        _check_options(algorithm, prob_domain, merge_impl, topk_impl)
        if log_probs.ndim != 3 or log_probs.dtype != torch.float32:
            raise ValueError("log_probs must be float32 [T, B, V]")
        log_domain = not prob_domain
        T, B, V = log_probs.shape
        W, L = beam_width, max_len
        if input_lengths is not None:
            if not log_domain:
                raise ValueError("input_lengths requires log-domain scores")
            if algorithm != "prefix":
                raise ValueError("input_lengths requires algorithm='prefix'")
            t_idx = torch.arange(T, device=log_probs.device)[:, None]
            pad = t_idx >= input_lengths.to(log_probs.device)[None, :]
            onehot_blank = torch.where(
                torch.arange(V, device=log_probs.device) == blank_id, 0.0,
                NEG_INF)
            log_probs = torch.where(pad[:, :, None],
                                    onehot_blank[None, None, :], log_probs)

        lm_q = _quantize_lm(lm_bias, V, log_probs.device)
        init = _init_beam(B, W, log_probs.device, log_domain)
        if _use_kernels(merge_impl, algorithm, log_domain, W, V,
                        log_probs.device, lm_q is not None, topk_impl):
            from gasr_tpu_torch.ops.cuda import fused_decode
            final, packed_ys = fused_decode.fused_prefix_decode(
                log_probs, init, blank_id, lm_q=lm_q)
            tokens, timesteps, _ = fused_decode.traceback(packed_ys,
                                                          final.length, L)
        elif _use_vocab_shards(merge_impl, algorithm, log_domain, W, V,
                               log_probs.device, lm_q is not None):
            from gasr_tpu_torch.ops.cuda import fused_decode
            final, packed_ys = _vocab_sharded_scan(log_probs, init,
                                                   blank_id)
            tokens, timesteps, _ = fused_decode.traceback(packed_ys,
                                                          final.length, L)
        else:
            step = _pick_step(blank_id, algorithm, log_domain, merge_impl,
                              lm_q, topk_impl)
            # the reference strips trailing blanks only on the final frame,
            # and never when T == 1
            final, packed_ys = _scan(log_probs, init, step,
                                     last_frame=algorithm == "reference"
                                     and T > 1)
            tokens, timesteps, _ = _traceback(packed_ys, final.length, L)
        return _result(final, tokens, timesteps, L, algorithm, log_domain)


# ---------------------------------------------------------------- streaming

def streaming_init(batch_size: int, beam_width: int, max_len: int = 256,
                   log_domain: bool = True, device="cuda") -> StreamingState:
    """Fresh streaming decode state for a batch, on `device` (the card
    unless the caller asks for "cpu")."""
    dev = device if isinstance(device, torch.device) else \
        resolve_device(device)
    beam = _init_beam(batch_size, beam_width, dev, log_domain)
    tokens = torch.full((batch_size, beam_width, max_len), -1,
                        dtype=torch.int32, device=dev)
    return StreamingState(beam=beam, tokens=tokens,
                          timesteps=torch.full_like(tokens, -1), frames=0)


def streaming_step(
    state: StreamingState,
    chunk_log_probs: torch.Tensor,          # [Tc, B, V]
    blank_id: int = 0,
    algorithm: str = "prefix",
    prob_domain: bool = False,
    is_final: bool = False,
    merge_impl: str = "auto",
    lm_bias: Optional[torch.Tensor] = None,
    active_len: Optional[int] = None,
) -> Tuple[StreamingState, BeamSearchResult]:
    """Advance the decode by one chunk; T is unbounded across calls.

    The beam state and the materialized prefixes carry over; per-chunk
    work is the batch path's. `is_final` applies the reference
    algorithm's trailing-blank strip on the chunk's last frame. Returns
    the new state and the current-best result snapshot; the snapshot's
    buffers are fresh tensors that later calls never write.

    Where `ctc_beam_search` would take the kernels, a chunk is one
    `fused_prefix_decode` launch from the carried state and one
    `traceback_overlay` launch. Elsewhere it takes the eager scan and
    `_traceback` with the base overlay, and `active_len` (the caller's
    promise that every prefix so far is shorter than it; any value >=
    min(L, frames + Tc) is safe) bounds that buffer pass: the all -1
    tail beyond it is attached as a constant pad.
    """
    with span("decode.search"):
        _check_options(algorithm, prob_domain, merge_impl)
        if (chunk_log_probs.ndim != 3
                or chunk_log_probs.dtype != torch.float32):
            raise ValueError("chunk_log_probs must be float32 [Tc, B, V]")
        log_domain = not prob_domain
        Tc, B, V = chunk_log_probs.shape
        W = state.beam.s1.shape[1]
        L = state.tokens.shape[2]
        lm_q = _quantize_lm(lm_bias, V, chunk_log_probs.device)

        if _use_kernels(merge_impl, algorithm, log_domain, W, V,
                        chunk_log_probs.device, lm_q is not None):
            from gasr_tpu_torch.ops.cuda import fused_decode
            final, packed_ys = fused_decode.fused_prefix_decode(
                chunk_log_probs, state.beam, blank_id, lm_q=lm_q)
            tokens, timesteps, _ = fused_decode.traceback_overlay(
                packed_ys, final.length, state.tokens, state.timesteps,
                state.frames)
        else:
            step = _pick_step(blank_id, algorithm, log_domain, merge_impl,
                              lm_q)
            final, packed_ys = _scan(chunk_log_probs, state.beam, step,
                                     last_frame=algorithm == "reference"
                                     and is_final)
            La = L if active_len is None else max(8, min(L, active_len))
            tokens, timesteps, _ = _traceback(
                packed_ys, final.length, La,
                base_tokens=state.tokens[:, :, :La],
                base_timesteps=state.timesteps[:, :, :La],
                t_offset=state.frames)
            if La < L:
                # the tail is untouched by contract (all -1)
                pad = (0, L - La)
                tokens = torch.nn.functional.pad(tokens, pad, value=-1)
                timesteps = torch.nn.functional.pad(timesteps, pad, value=-1)
        new_state = StreamingState(beam=final, tokens=tokens,
                                   timesteps=timesteps,
                                   frames=state.frames + Tc)
        return new_state, _result(final, tokens, timesteps, L, algorithm,
                                  log_domain)


def decode_to_lists(result: BeamSearchResult, top: int = 1):
    """Host-side: result -> list (per example) of (token_list, score).

    Spans: "decode.lists.fetch" (the copies to the host, which wait for
    the decode's kernels), "decode.lists.build" (the lists)."""
    with span("decode.lists"):
        with span("decode.lists.fetch"):
            tokens = result.tokens.cpu().numpy()
            lengths = result.lengths.cpu().numpy()
            scores = result.scores.cpu().numpy()
        with span("decode.lists.build"):
            L = tokens.shape[2]
            out = []
            for b in range(tokens.shape[0]):
                beams = []
                for w in range(min(top, tokens.shape[1])):
                    n = min(int(lengths[b, w]), L)
                    beams.append((tokens[b, w, :n].tolist(),
                                  float(scores[b, w])))
                out.append(beams if top > 1 else beams[0])
        return out
