"""The traceback kernel's schedule (`csrc/fused_decode.cu`,
`traceback_kernel`), emulated in PyTorch on the CPU, against the port's
plain version and the JAX package's `traceback_pallas(interpret=True)`.

The emulation follows the kernel block by block: G blocks an utterance
(`traceback_plan`), each with W / G slots and one walking thread a slot;
for each pass (`traceback_passes`: one, unless a row's min(L, T)
emissions do not fit the block's shared memory) ys[:, b, :] staged in
chunks of TC frames taken from the end backwards and walked; the q-th
kept emission (those at positions in [0, L)) collected on chip when q
falls in the pass's window of CAP; then each row's window of positions
written once: position p holds kept emission min(length, L) - 1 - p if
there is one, else -1 (the first pass also writes [min(length, L), L),
the last every position below its window). The outputs start as a
sentinel (what `torch.empty` may hold) and every cell must be written
exactly once. A variant that skips the -1 cells below the kept
emissions must fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu.ops.pallas.fused_decode import traceback_pallas

from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.ops.cuda import fused_decode as fd

SENTINEL = 0x5A5A5A5A


def emulate_traceback(ys, lens, L, plan=None, cap=None,
                      skip_low_fill=False):
    T, B, W = ys.shape
    TC, G = plan or fd.traceback_plan(W)
    CAP, npass = fd.traceback_passes(T, W, L, TC, G)
    if cap is not None:                     # a smaller buffer: more passes
        CAP, npass = cap, max(1, -(-min(L, T) // cap))
    rows = -(-W // G)
    tok = torch.full((B, W, L), SENTINEL, dtype=torch.int32)
    ts = torch.full((B, W, L), SENTINEL, dtype=torch.int32)
    writes = torch.zeros((B, W, L), dtype=torch.int32)
    start = torch.full((B, W), SENTINEL, dtype=torch.int32)
    for b in range(B):
        for g in range(G):
            r0 = g * rows
            nr = min(rows, W - r0)
            length = lens[b, r0:r0 + nr].long()
            he = torch.clamp(length, 0, L)   # the kept emissions' top
            for pas in range(npass):
                q0 = pas * CAP
                cur = torch.arange(r0, r0 + nr)
                pos = length.clone()
                q = torch.zeros(nr, dtype=torch.long)
                buf_t = torch.full((nr, max(CAP, 1)), -7, dtype=torch.long)
                buf_s = torch.full((nr, max(CAP, 1)), -7, dtype=torch.long)
                for c in range(-(-T // TC)):
                    hi = T - c * TC
                    lo = max(0, hi - TC)
                    frames = ys[lo:hi, b, :].long()   # the staged chunk
                    for f in range(hi - lo - 1, -1, -1):
                        packed = frames[f][cur]
                        a = ((packed >> 30) & 1).bool()
                        e = pos - 1
                        keep = a & (e >= 0) & (e < L)
                        k = q - q0
                        put = keep & (k >= 0) & (k < CAP)
                        rk = torch.nonzero(put).flatten()
                        buf_t[rk, k[rk]] = (packed[rk] >> 15) & 0x7FFF
                        buf_s[rk, k[rk]] = lo + f
                        q += keep.long()
                        pos -= a.long()
                        cur = packed & 0x7FFF
                if pas == npass - 1:
                    start[b, r0:r0 + nr] = cur.int()
                for r in range(nr):            # the row's window, once
                    h_ = int(he[r])
                    plo = 0 if pas == npass - 1 else max(h_ - (pas + 1) * CAP,
                                                         0)
                    phi = L if pas == 0 else h_ - pas * CAP
                    for p in range(plo, phi):
                        qq = h_ - 1 - p
                        if p >= h_ or qq >= int(q[r]):
                            if skip_low_fill and p < h_:
                                continue
                            tv = sv = -1
                        else:
                            tv = int(buf_t[r, qq - q0])
                            sv = int(buf_s[r, qq - q0])
                            assert tv >= 0 and sv >= 0   # from this pass
                        tok[b, r0 + r, p] = tv
                        ts[b, r0 + r, p] = sv
                        writes[b, r0 + r, p] += 1
    return tok, ts, start, writes


def _inputs(T, B, W, L, seed, extra=0):
    """Random backpointers, chars and append flags; lengths up to L +
    extra (0 among them)."""
    rng = np.random.default_rng(seed)
    ys = (rng.integers(0, W, (T, B, W)) | (rng.integers(0, 47, (T, B, W))
                                          << 15)
          | (rng.integers(0, 2, (T, B, W)) << 30)).astype(np.int32)
    lens = rng.integers(0, L + extra + 1, (B, W)).astype(np.int32)
    lens.flat[0] = 0
    return torch.from_numpy(ys), torch.from_numpy(lens)


def _check(ys, lens, L, plan=None, jax_too=True, cap=None):
    tok, ts, start, writes = emulate_traceback(ys, lens, L, plan, cap)
    assert bool((writes == 1).all())               # every cell once
    want = fd.traceback_plain(ys, lens, L)
    for got, w in zip((tok, ts, start), want):
        assert torch.equal(got, w)
    if jax_too:
        k = traceback_pallas(jnp.asarray(ys.numpy()),
                             jnp.asarray(lens.numpy()), L, interpret=True)
        for got, w in zip((tok, ts, start), k):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("T,B,W,L,extra,plan", [
    (23, 2, 5, 12, 10, (4, 1)),     # lengths past L, several chunks
    (9, 3, 1, 6, 3, None),          # W = 1
    (7, 1, 128, 9, 4, (2, 1)),      # W = 128
    (30, 2, 16, 40, 0, None),       # lengths within L, one chunk
    (5, 2, 4, 0, 2, None),          # L = 0: only start_parent
])
def test_traceback_schedule_matches_plain_and_jax(T, B, W, L, extra, plan):
    ys, lens = _inputs(T, B, W, L, T * 100 + W, extra)
    _check(ys, lens, L, plan)


def test_traceback_schedule_without_frames():
    # T = 0: every cell -1, each slot its own start
    ys, lens = _inputs(0, 2, 6, 8, 1, 3)
    _check(ys, lens, 8, jax_too=False)


def test_traceback_schedule_several_blocks_an_utterance():
    # W > 128: G = 2 blocks of 100 slots (past JAX's 128 lanes: plain only)
    ys, lens = _inputs(11, 2, 200, 7, 3, 5)
    assert fd.traceback_plan(200)[1] == 2
    _check(ys, lens, 7, (4, 2), jax_too=False)


def test_traceback_schedule_on_a_decode():
    # the backpointers of a real decode, in chunks of 3 frames
    rng = np.random.default_rng(4)
    T, B, W, V = 14, 2, 8, 6
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    lp = torch.from_numpy(x).log_softmax(-1)
    fin, ys = tbs._matched_scan(lp, tbs._init_beam(B, W, "cpu"), 0)
    assert int(fin.length.max()) > 4               # L = 4 drops the overflow
    for L in (4, 16):
        _check(ys, fin.length, L, (3, 1))


def test_traceback_schedule_in_several_passes():
    # rows whose emissions do not fit at once: the walk again for each
    # window of CAP positions, lengths past T and past L among them
    ys, lens = _inputs(13, 2, 6, 20, 9, 6)
    lens[0, 1] = 19                        # past T = 13
    _check(ys, lens, 20, (4, 1), cap=5)
    ys, lens = _inputs(9, 1, 3, 4, 11, 8)  # lengths past L
    _check(ys, lens, 4, (2, 1), cap=1)


def test_traceback_schedule_skipping_the_low_fill_fails():
    ys, lens = _inputs(6, 2, 8, 12, 7, 0)
    lens[:] = 12            # more length than 6 frames can emit
    tok, _, _, writes = emulate_traceback(ys, lens, 12, (2, 1),
                                          skip_low_fill=True)
    want, _, _ = fd.traceback_plain(ys, lens, 12)
    assert not bool((writes == 1).all())
    assert not torch.equal(tok, want)


def test_traceback_plan():
    # reference_large (W = 100), conformer_l (W = 16), the LM edges (W =
    # 64): one block an utterance, every row's emissions in one pass
    assert fd.traceback_plan(100) == (32, 1)
    assert fd.traceback_plan(16) == (64, 1)
    assert fd.traceback_plan(64) == (64, 1)
    assert fd.traceback_plan(128) == (32, 1)
    assert fd.traceback_plan(129) == (16, 2)
    for T, W, L in ((200, 100, 256), (300, 16, 256), (200, 64, 256),
                    (600, 128, 256)):
        assert fd.traceback_passes(T, W, L, *fd.traceback_plan(W)) == (
            min(L, T), 1)
        assert fd.traceback_smem(T, W, L, *fd.traceback_plan(W)) <= \
            fd.SMEM_MAX
    # long rows of many slots: passes; past 2^17 frames, 6-byte entries
    cap, npass = fd.traceback_passes(2000, 128, 2048, 32, 1)
    assert npass > 1 and cap * npass >= 2000
    assert fd.traceback_smem(2000, 128, 2048, 32, 1) <= fd.SMEM_MAX
    assert fd.traceback_passes(200000, 4, 8, 64, 1) == (8, 1)
    for W in (1, 7, 100, 128, 129, 1000, 4096):
        TC, G = fd.traceback_plan(W)
        assert -(-W // G) <= fd.TB_ROWS
        assert 2 * TC * W * 4 <= fd.TB_STAGE_BYTES or TC == 1
    # not even one emission a row beside one staged frame: refused
    assert fd.traceback_passes(10, 2 ** 15, 4, *fd.traceback_plan(
        2 ** 15))[1] == 0
