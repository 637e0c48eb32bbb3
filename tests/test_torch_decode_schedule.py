"""The decode kernel's frame schedule (`csrc/fused_decode.cu` on the phases
of `csrc/decode_frame.cuh` and the filtered top-W of `csrc/topk.cuh`),
emulated in numpy and PyTorch on the CPU, against the port's plain
versions (`ops/cuda/topk.py::topk_plain`,
`decoder/beam_search.py::_matched_scan`) and the JAX package's
`fused_prefix_decode(..., interpret=True)`.

The emulation follows the kernel step by step.
  Match: for each stay slot w' a warp tests 32 candidate parents w a
    ballot (live, h1 == hp1[w'], k2 == 31*hp2[w'] + length[w'] - 1); the
    lowest set bit of the first non-empty ballot is the parent.
  Seed: thread t's largest seed score over its cells t, t + 32*warps,
    ... (the extends' scores without the absorbed-extend exclusion, as
    monotone bits; 0 in the blank column); each warp's c-th largest
    maximum, c = ceil(2W / warps); theta starts at the least of them,
    shifted into a key's high half.
  Walk: every warp walks its chunks of 32 cells in slot order; the warps
    take turns in a seeded random interleaving (the card gives no
    order). A warp reads the shared theta at each chunk; keys >= theta
    are compacted into its buffer in lane order; a buffer of 32 is sorted
    and merged into the warp's list of 32R keys (R = 1, 2, 4 with 32R >=
    W); a list with W real keys raises theta to its W-th key at once.
  Rank: each list key's place in its list plus the count of larger keys
    in every other list; the keys of rank < W are the frame's top-W.
  Update: the kernel's expressions (those of `_frame_step`) from the
    winners' keys.
The bitonic networks that sort a run and merge it into a list are
emulated apart, register by register and lane by lane
(`warp_bitonic_level`), against numpy's sort.

Everything here is exact: keys are integers, and the float arithmetic is
the plain version's tensor ops in the same order, so the emulated decode
must equal `_matched_scan` in every bit. Three wrong schedules must fail
on tie rows: dropping a key equal to theta (`key <= theta`), dropping on
the score (the float score <= theta's score), and raising theta from a
list that holds fewer than W real keys. A fourth, a seed of W maxima in
place of 2W, must fail under shallow fusion: without an LM every
absorbed extend's stay scores at least as high as the extend and lies
outside the seed (the blank column), so W maxima would still leave W
real keys at or above theta; with an LM term (which the stay does not
take) the extend can outscore its stay, and in a vocab shard's window
the stay may lie in another window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.ops.pallas.fused_decode import fused_prefix_decode, pack_state

from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.ops.cuda import fused_decode
from gasr_tpu_torch.ops.cuda.topk import monotone_bits, topk_plain
from chip_smoke import signed_zero_state
from test_torch_cuda import signed_zero_log_probs

LOW32 = (1 << 32) - 1
WARPS = 16                  # the kernel's warps (512 threads)
SCORE_TOL = 1e-5            # JAX on the CPU: XLA's exp/log1p in the last bits


# ------------------------------------------------------------- keys

def keys_of(vals: torch.Tensor, gidx) -> np.ndarray:
    """topk_key: monotone score bits high, inverted index low (uint64)."""
    mono = monotone_bits(vals.reshape(-1)).numpy().astype(np.uint64)
    idx = np.asarray(gidx, dtype=np.uint64).reshape(-1)
    return (mono << np.uint64(32)) | (np.uint64(LOW32) - idx)


def key_score(key: int) -> float:
    m = np.uint32(key >> 32)
    u = (m & np.uint32(0x7FFFFFFF)) if m >= 0x80000000 else ~m
    return float(np.array([u], np.uint32).view(np.float32)[0])


def list_regs(W: int) -> int:
    return 1 if W <= 32 else (2 if W <= 64 else 4)


# ------------------------------------------------------ warp networks

def bitonic_level(v: np.ndarray, K: int) -> np.ndarray:
    """warp_bitonic_level<K, R> on a list v of 32R keys (element e =
    32 r + lane): register swaps for j >= 32, xor-shuffles below."""
    v = v.copy()
    e = np.arange(len(v))
    j = K // 2
    while j > 0:
        p = v[e ^ j]
        desc = (e & K) == 0
        lower = (e & j) == 0
        v = np.where(lower == desc, np.maximum(v, p), np.minimum(v, p))
        j //= 2
    return v


def warp_sort32(x: np.ndarray) -> np.ndarray:
    for K in (2, 4, 8, 16, 32):
        x = bitonic_level(x, K)
    return x


def warp_merge_run(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (32R, descending) := the largest 32R of a and the sorted run b."""
    a = a.copy()
    a[-32:] = np.maximum(a[-32:], b[::-1])      # lane l takes b[31 - l]
    return bitonic_level(a, len(a))


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
def test_warp_networks_sort_and_merge(R, kind):
    rng = np.random.default_rng(R * 7 + len(kind))
    for _ in range(20):
        if kind == "random":
            run = rng.integers(1, 2 ** 63, 32, dtype=np.uint64)
            lst = rng.integers(1, 2 ** 63, 32 * R, dtype=np.uint64)
        else:
            hi = 3 if kind == "ties" else 1
            run = rng.integers(0, hi, 32).astype(np.uint64)
            lst = rng.integers(0, hi, 32 * R).astype(np.uint64)
        s = warp_sort32(run)
        np.testing.assert_array_equal(s, np.sort(run)[::-1])
        lst = np.sort(lst)[::-1]
        got = warp_merge_run(lst, s)
        want = np.sort(np.concatenate([lst, run]))[::-1][:32 * R]
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the selection

class Wrong:
    KEY_LE = "drop key <= theta"
    SCORE_LE = "drop on the score"
    SHORT_LIST = "theta from a list with fewer than W real keys"
    SEED_W = "a seed of W maxima, not 2W"


def _drop(key: int, th: int, variant) -> bool:
    if variant == Wrong.KEY_LE:
        return key <= th
    if variant == Wrong.SCORE_LE and th != 0:
        return key_score(key) <= key_score(th)
    return key < th


def select(keys: np.ndarray, seed_keys, W: int, warps: int = WARPS,
           seed_mult: int = 2, order_seed: int = 0, variant=None,
           stats=None) -> np.ndarray:
    """The filtered top-W of `keys` (one per cell, in grid order): the
    seed, the walk in a seeded interleaving of the warps, the ranks.
    Returns the W winners' keys, descending (0 where a rank is missing)."""
    n = len(keys)
    threads = 32 * warps
    R = list_regs(W)
    cap = 32 * R
    keys = [int(k) for k in keys]
    # seed: each thread's largest seed score (its monotone bits, the
    # key's high half), each warp's c-th largest; theta = the least << 32
    th_seed = 0
    if seed_keys is not None:
        bits = [int(k) >> 32 for k in seed_keys]
        m = [max(bits[t::threads], default=0) for t in range(threads)]
        c = -(-seed_mult * W // warps)
        q = [sorted(m[32 * j:32 * j + 32], reverse=True)[c - 1]
             if c <= 32 else 0 for j in range(warps)]
        th_seed = min(q) << 32
    theta = [0]
    lists = [[] for _ in range(warps)]
    nreal = [0] * warps
    bufs = [[] for _ in range(warps)]
    th = [th_seed] * warps
    chunks = [list(range(32 * j, n, threads)) for j in range(warps)]
    kept = [0]

    def flush(j, run):
        lists[j] = sorted(lists[j] + run, reverse=True)[:cap]
        nreal[j] = min(cap, nreal[j] + len(run))
        if nreal[j] >= W:
            kw = lists[j][W - 1]
        elif variant == Wrong.SHORT_LIST and nreal[j] > 0:
            kw = lists[j][nreal[j] - 1]
        else:
            return
        th[j] = max(th[j], kw)
        theta[0] = max(theta[0], kw)

    def filter_round(j, cells):
        """A chunk's keys not below theta go into the buffer in lane
        order; a buffer of 32 is merged."""
        th[j] = max(th[j], theta[0])
        for i in cells:
            if not _drop(keys[i], th[j], variant):
                bufs[j].append(keys[i])
                kept[0] += 1
        if len(bufs[j]) >= 32:
            run, bufs[j] = bufs[j][:32], bufs[j][32:]
            flush(j, run)

    rng = np.random.default_rng(order_seed)
    live = [j for j in range(warps)]
    while live:
        j = live[int(rng.integers(len(live)))]
        if chunks[j]:
            base = chunks[j].pop(0)
            filter_round(j, range(base, min(base + 32, n)))
        else:                                   # the last flush
            if bufs[j]:
                flush(j, bufs[j])
                bufs[j] = []
            live.remove(j)
    # rank
    top = [0] * W
    thf = theta[0]
    for j in range(warps):
        for e in range(min(nreal[j], W)):
            x = lists[j][e]
            if _drop(x, thf, variant):
                break
            rank = e + sum(sum(1 for y in lists[o][:min(nreal[o], W)]
                               if y > x)
                           for o in range(warps) if o != j)
            if rank < W:
                assert top[rank] == 0, "two keys of one rank"
                top[rank] = x
    if stats is not None:
        stats.append(kept[0])
    return np.array(top, dtype=np.uint64)


def _rows(kind, n, rng):
    if kind == "random":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "ties":
        return (np.round(rng.standard_normal(n) * 2) / 2).astype(np.float32)
    if kind == "uniform":
        return np.full(n, -np.log(47.0), np.float32)
    x = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)  # +-0.0
    x[rng.integers(0, n, 3)] = -1.0
    return x


@pytest.mark.parametrize("kind", ["random", "ties", "uniform", "zeros"])
@pytest.mark.parametrize("n,W,warps", [(4700, 100, 16), (2064, 16, 16),
                                       (300, 8, 2), (96, 3, 1), (40, 64, 2)])
def test_selection_equals_topk_plain(kind, n, W, warps):
    rng = np.random.default_rng(n + W)
    x = torch.from_numpy(_rows(kind, n, rng))
    keys = keys_of(x, np.arange(n))
    want_v, want_i = topk_plain(x[None], min(W, n))
    for order in range(3):
        top = select(keys, keys, min(W, n), warps, seed_mult=1,
                     order_seed=order)
        np.testing.assert_array_equal(
            (np.uint64(LOW32) - (top & np.uint64(LOW32))).astype(np.int64),
            want_i[0].numpy())
        np.testing.assert_array_equal(
            top >> np.uint64(32),
            monotone_bits(want_v[0]).numpy().astype(np.uint64))


# ------------------------------------------------------- the frame

def emulate_frame(state, f, blank, lm_q=None, warps=WARPS, order_seed=0,
                  variant=None, stats=None):
    """One frame of the kernel for every utterance of the batch: the
    beam's per-slot values, the ballot match, the stays, the seed, the
    walk, the ranks and the update, with `_frame_step`'s expressions."""
    B, W = state.s1.shape
    V = f.shape[1]
    pb, pnb, live = state.s1, state.s2, state.live
    last = state.last.long()
    length = state.length.long()
    total = tbs._logaddexp(pb, pnb)
    last_clip = last.clamp(0, V - 1)
    f_last = torch.gather(f, 1, last_clip)
    k2 = (state.h2 * 31 + length) & tbs.MASK32

    # ballot match: the first live w of the first non-empty ballot
    match = torch.zeros(B, W, dtype=torch.long)
    has_match = torch.zeros(B, W, dtype=torch.bool)
    for b in range(B):
        h1, k2b, lv = state.h1[b], k2[b], live[b]
        for wp in range(W):
            if not lv[wp]:
                continue
            want1 = state.hp1[b, wp]
            want2 = (state.hp2[b, wp] * 31 + length[b, wp] - 1) & tbs.MASK32
            for q in range(0, W, 32):
                ballot = [w for w in range(q, min(q + 32, W))
                          if lv[w] and h1[w] == want1 and k2b[w] == want2]
                if ballot:
                    match[b, wp], has_match[b, wp] = min(ballot), True
                    break

    # stays, with match_seed's expressions
    stay_pb = total + f[:, blank:blank + 1]
    stay_pnb = torch.where(length > 0, pnb + f_last, tbs.NEG_INF)
    pb_m, pnb_m = torch.gather(pb, 1, match), torch.gather(pnb, 1, match)
    last_m = torch.gather(last, 1, match)
    base = torch.where(last_m == last, pb_m, tbs._logaddexp(pb_m, pnb_m))
    ext_contrib = torch.where(has_match, base + f_last, tbs.NEG_INF)
    stay_pnb = tbs._logaddexp(stay_pnb, ext_contrib)
    sscore = torch.where(live, tbs._logaddexp(stay_pb, stay_pnb),
                         tbs.DEAD_KEY_LOG)

    # the extends; the seed's keys know no exclusion
    vs = torch.arange(V)
    ext = torch.where(vs[None, None, :] == last[:, :, None], pb[:, :, None],
                      total[:, :, None]) + f[:, None, :]
    if lm_q is not None:
        ext = ext + lm_q[(last + 1).clamp(0, V)]
    ext_live = torch.where(live[:, :, None], ext, tbs.DEAD_KEY_LOG)
    excl = torch.zeros(B, W, V, dtype=torch.bool)
    for b in range(B):
        for wp in range(W):
            v = int(last_clip[b, wp])
            if has_match[b, wp] and v != blank:
                excl[b, match[b, wp], v] = True
    cand = torch.where(excl, tbs.DEAD_KEY_LOG, ext_live)
    cand = torch.where((vs == blank)[None, None, :], sscore[:, :, None],
                       cand)

    gidx = np.arange(W * V)
    w_sel = torch.zeros(B, W, dtype=torch.long)
    v_sel = torch.zeros(B, W, dtype=torch.long)
    top_vals = torch.zeros(B, W)
    for b in range(B):
        keys = keys_of(cand[b], gidx)
        seed = keys_of(ext_live[b], gidx)
        seed[gidx % V == blank] = 0
        top = select(keys, seed, W, warps,
                     1 if variant == Wrong.SEED_W else 2, order_seed + b,
                     variant, stats)
        idx = (np.uint64(LOW32) - (top & np.uint64(LOW32))).astype(np.int64)
        if (top == 0).any():                 # a rank nobody took
            idx[top == 0] = 0
        w_sel[b] = torch.from_numpy(idx // V)
        v_sel[b] = torch.from_numpy(idx % V)
        top_vals[b] = torch.gather(cand[b].reshape(-1), 0,
                                   torch.from_numpy(idx))
        if (top == 0).any():
            top_vals[b, torch.from_numpy(top == 0)] = float("nan")

    # update, with _frame_step's expressions
    is_stay = v_sel == blank
    new_live = top_vals > tbs.DEAD_KEY_LOG * 0.5

    def g(x):
        return torch.gather(x, 1, w_sel)

    h1g, h2g = g(state.h1), g(state.h2)
    sel_ext = torch.gather(ext.reshape(B, W * V), 1, w_sel * V + v_sel)
    n_last = torch.where(is_stay, g(last), v_sel)
    vp1 = v_sel + 1
    new = tbs._BeamState(
        h1=torch.where(is_stay, h1g, (h1g * tbs.M1 + vp1) & tbs.MASK32),
        h2=torch.where(is_stay, h2g, (h2g * tbs.M2 + vp1) & tbs.MASK32),
        hp1=torch.where(is_stay, g(state.hp1), h1g),
        hp2=torch.where(is_stay, g(state.hp2), h2g),
        last=n_last.to(torch.int32),
        length=(g(length) + (~is_stay).long()).to(torch.int32),
        tb=torch.zeros_like(state.length),
        live=new_live,
        s1=torch.where(new_live & is_stay, g(stay_pb), tbs.NEG_INF),
        s2=torch.where(new_live, torch.where(is_stay, g(stay_pnb), sel_ext),
                       tbs.NEG_INF),
    )
    return new, tbs._pack_ys(w_sel, n_last, (~is_stay) & new_live), cand


def emulate_scan(lp, init, blank=0, lm_q=None, warps=WARPS, order_seed=0,
                 variant=None, stats=None, check_topk=False):
    T = lp.shape[0]
    state, ys = init, []
    for t in range(T):
        new, y, cand = emulate_frame(state, lp[t], blank, lm_q, warps,
                                     order_seed + 97 * t, variant, stats)
        if check_topk:
            _, idx = topk_plain(cand.reshape(cand.shape[0], -1),
                                cand.shape[1])
            want = tbs._pack_ys(idx.long() // lp.shape[2],
                                new.last.long(), torch.zeros_like(
                                    new.live)) & 0x7FFF
            assert torch.equal(y & 0x7FFF, want), f"frame {t}"
        state = new
        ys.append(y)
    return state, torch.stack(ys)


def _lp(kind, T, B, V, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    if kind == "random":
        x = x - x.max(-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
    if kind == "relu":                      # compat_final_relu: many ties
        return np.maximum(np.round(x * 2) / 2, 0.0).astype(np.float32)
    if kind == "uniform":
        return np.full((T, B, V), -np.log(V), np.float32)
    # +-0.0 and a few exact values
    z = np.where(rng.random((T, B, V)) < 0.5, 0.0, -0.0).astype(np.float32)
    return np.where(rng.random((T, B, V)) < 0.2, -1.0, z).astype(np.float32)


def _same_state(got, want):
    for name in fused_decode.FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if name in ("s1", "s2"):
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a.long(), b.long()), name


def _table(V, seed):
    rng = np.random.default_rng(seed)
    lm = (rng.standard_normal((V + 1, V)) * 2).astype(np.float32)
    lm[::3, ::4] = -0.0
    return tbs._quantize_lm(torch.from_numpy(lm), V, "cpu")


CASES = [(W, V, kind) for W, V in ((1, 8), (3, 12), (8, 8), (16, 12))
         for kind in ("random", "relu", "uniform", "zeros")]


@pytest.mark.parametrize("W,V,kind", CASES)
def test_emulated_decode_equals_matched_scan(W, V, kind):
    T, B = 6, 2
    lp = torch.from_numpy(_lp(kind, T, B, V, W * V))
    init = tbs._init_beam(B, W, "cpu")       # frame 0: fewer live than W
    want_st, want_ys = tbs._matched_scan(lp, init, 0)
    for warps, order in ((WARPS, 0), (2, 1), (1, 2)):
        st, ys = emulate_scan(lp, init, 0, None, warps, order,
                              check_topk=warps == WARPS)
        assert torch.equal(ys, want_ys), (warps, order)
        _same_state(st, want_st)


@pytest.mark.parametrize("W,V", [(8, 12), (16, 12), (100, 47)])
def test_emulated_decode_on_signed_zero_ties(W, V):
    """From `signed_zero_state`, frame 0 ties -0.0 extends with +0.0 ones
    (a fresh beam never scores -0.0): the seed, the walk and the ranks on
    the 64-bit keys keep lax.top_k's order there, +0.0 first (also
    lax.approx_max_k's at k < n, topk_impl="approx"), and a -0.0 key
    below the +0.0 threshold is dropped, as the plain scan drops it."""
    T, B = 3, 1
    lp = torch.from_numpy(signed_zero_log_probs(T, B, V, W))
    init = signed_zero_state(B, W, V, "cpu")
    want_st, want_ys = tbs._matched_scan(lp, init, 0)
    for warps, order in ((WARPS, 0), (2, 1)):
        st, ys = emulate_scan(lp, init, 0, None, warps, order,
                              check_topk=warps == WARPS)
        assert torch.equal(ys, want_ys), (warps, order)
        _same_state(st, want_st)


@pytest.mark.parametrize("W,V,blank", [(8, 12, 0), (16, 8, 3)])
def test_emulated_lm_decode_equals_matched_scan(W, V, blank):
    T, B = 5, 2
    lp = torch.from_numpy(_lp("relu", T, B, V, V))
    lm_q = _table(V, W)
    init = tbs._init_beam(B, W, "cpu")
    want_st, want_ys = tbs._matched_scan(lp, init, blank, lm_q)
    for warps, order in ((WARPS, 3), (2, 4)):
        st, ys = emulate_scan(lp, init, blank, lm_q, warps, order)
        assert torch.equal(ys, want_ys)
        _same_state(st, want_st)


@pytest.mark.parametrize("W,V,kind,lm", [(8, 8, "random", False),
                                         (16, 12, "relu", True)])
def test_emulated_decode_equals_jax_kernel_interpret(W, V, kind, lm):
    T, B = 4, 2
    lp = _lp(kind, T, B, V, 3)
    lm_q = _table(V, 5) if lm else None
    out = fused_prefix_decode(
        jnp.asarray(lp), pack_state(jbs._init_beam(B, W, True)), W=W, V=V,
        blank_id=0, interpret=True, sel_mode="exact",
        lm_q=None if lm_q is None else jnp.asarray(lm_q.numpy()))
    st, ys = emulate_scan(torch.from_numpy(lp), tbs._init_beam(B, W, "cpu"),
                          0, lm_q, 2, 7)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(out.ys))
    for name in ("h1", "h2", "hp1", "hp2", "last", "length", "live"):
        np.testing.assert_array_equal(
            getattr(st, name).numpy(),
            np.asarray(getattr(out, name)).astype(
                getattr(st, name).numpy().dtype), name)
    for name in ("s1", "s2"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(out, name)),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


def test_seeded_threshold_drops_most_candidates():
    """At reference_large's width (W=100, V=47) the seed alone leaves a
    few hundred of the 4,700 candidates a frame to the lists."""
    T, B, W, V = 3, 1, 100, 47
    lp = torch.from_numpy(_lp("random", T, B, V, 11))
    state, _ = tbs._matched_scan(lp[:2], tbs._init_beam(B, W, "cpu"), 0)
    kept = []
    emulate_frame(state, lp[2], 0, stats=kept)
    want_st, want_ys = tbs._frame_step(state, lp[2], 0)
    new, ys, _ = emulate_frame(state, lp[2], 0)
    assert torch.equal(ys, want_ys)
    _same_state(new, want_st)
    assert W <= kept[0] <= 1000, kept


@pytest.mark.parametrize("variant", [Wrong.KEY_LE, Wrong.SCORE_LE,
                                     Wrong.SHORT_LIST])
def test_wrong_schedules_fail_on_tie_rows(variant):
    """Each wrong schedule gives another beam than the plain decode on at
    least one tie-heavy input (uniform log-probs, relu rows)."""
    failed = []
    for W, V, kind in ((1, 8, "uniform"), (8, 8, "uniform"),
                       (16, 12, "relu"), (3, 12, "relu")):
        lp = torch.from_numpy(_lp(kind, 3, 1, V, W))
        init = tbs._init_beam(1, W, "cpu")
        want_st, want_ys = tbs._matched_scan(lp, init, 0)
        st, ys = emulate_scan(lp, init, 0, None, WARPS, 0, variant)
        right = torch.equal(ys, want_ys)
        try:
            _same_state(st, want_st)
        except AssertionError:
            right = False
        if not right:
            failed.append((W, V, kind))
    assert failed, f"{variant}: equal to the plain decode on every tie row"


@pytest.mark.parametrize("W,V,kind,warps,seed", [(8, 8, "random", 1, 0),
                                                 (8, 8, "zeros", 2, 2),
                                                 (8, 12, "relu", 1, 3)])
def test_seed_of_w_maxima_fails_with_an_lm(W, V, kind, warps, seed):
    """With an LM table (positive entries too) the absorbed extends can
    fill the seed's maxima: a seed of W maxima drops a winner, and the
    kernel's 2W do not. One or two warps, so that the seed's maxima come
    from the grid and not from idle threads' zeros."""
    lp = torch.from_numpy(_lp(kind, 4, 1, V, seed))
    lm_q = _table(V, seed)
    init = tbs._init_beam(1, W, "cpu")
    want_st, want_ys = tbs._matched_scan(lp, init, 0, lm_q)
    st, ys = emulate_scan(lp, init, 0, lm_q, warps, 0)
    assert torch.equal(ys, want_ys)
    _same_state(st, want_st)
    st, ys = emulate_scan(lp, init, 0, lm_q, warps, 0, Wrong.SEED_W)
    right = torch.equal(ys, want_ys)
    try:
        _same_state(st, want_st)
    except AssertionError:
        right = False
    assert not right, "a seed of W maxima gave the plain decode's beam"
