"""The fused stem kernels' algorithm (`csrc/stem.cu`), emulated in PyTorch
on the CPU, against the stem's math in float64, the port's plain version
and the JAX package's `stem_ref` and `fused_stem(interpret=True)`.

The emulation follows the kernels' schedule. conv2's columns f2 are cut
into the wrapper's `f2_windows` windows (fa, fw): fw = F2 // NW or one
more, at most `WINDOW_MAX`; a window's rows are (t2, f2 - fa) flattened
within one b and cut into tiles of `tile` rows; a tile covers t2 in
[ta, tb] and holds the h1 region of rows 2 ta .. 2 tb + 2 and columns
2 fa .. 2 (fa + fw) (the last row or column may be conv2's zero pad).
The region is the im2col of x (9 taps, x row T and column F zero) times
w1 per 32-channel chunk, + b1, clipped and rounded, with the pad
positions written as zeros, stored even columns first; conv2 reads each
tap (di, dj) of each row at region position 2 (t2 - ta) PW + f2 - fa +
di PW + (fw + 1 if dj = 1 else dj / 2) (PW = 2 fw + 1), sums chunk by
chunk and tap by tap, adds b2, clips and rounds (the h2 tile, written at
its (t2, f2)); sub_proj multiplies h2 seen as [B T/4, (F/4) d] by wp in
row tiles and 32-deep K slices and adds bp. A region never holds more
than REGION_MAX positions at any F (the kernel's shared memory).

Tolerances:
  EXACT     the emulation in float64 against the stem's math in float64
            (F.conv2d with lax "SAME" pads, no rounding): the same products
            summed in another order, so they agree to the last bits.
  BF16_REL  0.02 * max(1, max|ref|), the JAX package's own kernel-against-
            oracle bound (tests/test_stem.py): the emulation rounds conv1
            after b1 where the port's plain version on the card rounds
            before it, and float32 sums in another order flip some bf16
            roundings of h1 and h2 (2^-8 relative each); the JAX kernel
            also rounds b2 to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gasr_tpu.ops.pallas import stem as jstem

from gasr_tpu_torch.ops import conv as tconv
from gasr_tpu_torch.ops.cuda import stem as tstem

EXACT = 1e-9
BF16_REL = 0.02
CK = 32                    # channels of a chunk, K of a sub_proj slice
REGION_MAX = 735           # csrc/stem.cu's kRegionMax: region positions

# (B, T, F, d, dout, tile)
CASES = [
    (2, 40, 12, 128, 128, 16),     # T2 = 10, F2 = 3: 30 rows, a ragged tile
    (2, 16, 8, 128, 256, 128),     # F2 = 2, one tile a b
    (1, 8, 8, 128, 128, 128),      # T = F = 8: the smallest eligible
    (1, 12, 8, 1024, 128, 16),     # d = 1024
    (1, 16, 12, 128, 1024, 16),    # dout = 1024
]
IDS = ["T2_10_F2_3", "F2_2", "T8_F8", "d1024", "dout1024"]


def _weights(F_, d, dout, seed, b1_shift=0.0):
    rng = np.random.default_rng(seed)
    g = lambda *shape, s: (rng.standard_normal(shape) * s).astype(  # noqa
        np.float32)
    return (g(3, 3, 1, d, s=0.3), g(d, s=0.1) + np.float32(b1_shift),
            g(3, 3, d, d, s=(9 * d) ** -0.5), g(d, s=0.1),
            g(F_ // 4 * d, dout, s=(F_ // 4 * d) ** -0.5 * 2), g(dout, s=0.1))


def _x(B, T, F_, seed):
    return np.random.default_rng(seed).uniform(size=(B, T, F_)).astype(
        np.float32)


def _r16(a):
    return a.to(torch.bfloat16).to(a.dtype)


def _windows(F_, window_max=None):
    """The conv kernel's f2 windows (fa, fw): `f2_windows` of them, the
    first F2 % NW one column wider."""
    F2 = F_ // 4
    NW = (tstem.f2_windows(F2) if window_max is None
          else -(-F2 // window_max))
    q, rem = divmod(F2, NW)
    return [(w * q + min(w, rem), q + (w < rem)) for w in range(NW)]


def _tile(T, F_, m0, tile, fw=None):
    """(ta, R): the tile's first t2 and its region rows (in a window of
    fw columns; all F/4 by default)."""
    T2, fw = T // 4, fw or F_ // 4
    ta = m0 // fw
    tb = min((m0 + tile - 1) // fw, T2 - 1)
    return ta, 2 * (tb - ta) + 3


def _slot(c, fw):
    """A region column's place in its row: even columns first."""
    return c // 2 + (fw + 1) * (c % 2)


def _im2col_table(xb, T, F_, ta, R, rnd, fa=0, fw=None):
    """im2col [P, 9] of the x under the region of window (fa, fw) (x row
    T and column F zero) and, per position, its region index and whether
    it is conv2's zero pad (h1 row T/2 or column F/2)."""
    fw = fw or F_ // 4
    PW = 2 * fw + 1
    P = R * PW
    r = torch.arange(P) // PW
    c = torch.arange(P) % PW
    xp = F.pad(rnd(xb), (0, 3, 0, 4 * ta + 2 * R + 2 - xb.shape[0]))
    cols = torch.stack([xp[4 * ta + 2 * r + ki, 4 * fa + 2 * c + kj]
                        for ki in range(3) for kj in range(3)], dim=1)
    # x past row T or column F is the pad: zero
    t_ok = torch.stack([4 * ta + 2 * r + ki < T for ki in range(3)
                        for _ in range(3)], dim=1)
    f_ok = torch.stack([4 * fa + 2 * c + kj < F_ for _ in range(3)
                        for kj in range(3)], dim=1)
    cols = torch.where(t_ok & f_ok, cols, 0.0)
    pad = (2 * ta + r >= T // 2) | (2 * fa + c >= F_ // 2)
    return cols, r * PW + _slot(c, fw), pad


def _region(cols, idx, pad, w1c, b1c, rnd, compute_pad=False):
    """One chunk's region [P, CK]: conv1 + b1, clipped, rounded; the pad
    positions zero (compute_pad=True computes them: the bug the JAX
    package's first cut had)."""
    h = rnd((cols @ w1c + b1c).clamp(0.0, 20.0))
    if not compute_pad:
        h = torch.where(pad[:, None], 0.0, h)
    reg = torch.full_like(h, float("nan"))
    reg[idx] = h
    return reg


def _tap_rows(m0, tile, rows, ta, T, F_, di, dj, fw=None):
    """Region positions read by tap (di, dj) for the tile's rows (rows
    past the window's last are clamped to it, as the kernel's lanes are)."""
    fw = fw or F_ // 4
    PW = 2 * fw + 1
    m = torch.clamp(torch.arange(m0, m0 + tile), max=rows - 1)
    base = 2 * (m // fw - ta) * PW + m % fw
    return base + di * PW + ((fw + 1) if dj == 1 else dj // 2)


def _conv_tiles(x, w1, b1, w2, b2, tile, rnd, acc_dtype, compute_pad=False,
                window_max=None):
    """h2 [B, T2, F2, d] by the conv kernel's windows, tiles and chunks."""
    B, T, F_ = x.shape
    d = w2.shape[-1]
    T2, F2 = T // 4, F_ // 4
    w1t = rnd(w1.reshape(9, d)).to(acc_dtype)
    w2t = rnd(w2.reshape(9, d, d)).to(acc_dtype)
    h2 = torch.full((B, T2, F2, d), float("nan"), dtype=acc_dtype)
    for b in range(B):
        for fa, fw in _windows(F_, window_max):
            rows = T2 * fw
            for m0 in range(0, rows, tile):
                ta, R = _tile(T, F_, m0, tile, fw)
                assert R * (2 * fw + 1) <= REGION_MAX
                cols, idx, pad = _im2col_table(x[b].to(acc_dtype), T, F_, ta,
                                               R, rnd, fa, fw)
                acc = torch.zeros(tile, d, dtype=acc_dtype)
                for c0 in range(0, d, CK):
                    reg = _region(cols, idx, pad, w1t[:, c0:c0 + CK],
                                  b1[c0:c0 + CK].to(acc_dtype), rnd,
                                  compute_pad)
                    for tap in range(9):
                        a = reg[_tap_rows(m0, tile, rows, ta, T, F_,
                                          tap // 3, tap % 3, fw)]
                        acc += a @ w2t[tap, c0:c0 + CK]
                m = torch.arange(m0, min(m0 + tile, rows))
                h2[b, m // fw, fa + m % fw] = rnd(
                    (acc[:len(m)] + b2.to(acc_dtype)).clamp(0.0, 20.0))
    assert not bool(h2.isnan().any())          # every row written
    return h2


def _proj_tiles(h2, wp, bp, tile, rnd, acc_dtype):
    """out [B, T2, dout] by the sub_proj kernel's row tiles and K slices."""
    B, T2, F2, d = h2.shape
    A = h2.reshape(B * T2, F2 * d)
    W = rnd(wp).to(acc_dtype)
    out = torch.empty(B * T2, wp.shape[1], dtype=acc_dtype)
    for m0 in range(0, B * T2, tile):
        acc = torch.zeros(A[m0:m0 + tile].shape[0], wp.shape[1],
                          dtype=acc_dtype)
        for k0 in range(0, F2 * d, CK):
            acc += A[m0:m0 + tile, k0:k0 + CK] @ W[k0:k0 + CK]
        out[m0:m0 + tile] = acc + rnd(bp).to(acc_dtype)
    return out.reshape(B, T2, -1)


def _emulate(x, w1, b1, w2, b2, wp, bp, tile=128, exact=False,
             out_dtype=torch.bfloat16, compute_pad=False, window_max=None):
    """The kernels' schedule: float64 without roundings (exact), or bf16
    operands with float32 sums at the kernels' rounding points."""
    if exact:
        rnd, acc = (lambda a: a), torch.float64
        args = [a.double() for a in (x, w1, b1, w2, b2, wp, bp)]
    else:
        rnd, acc = _r16, torch.float32
        args = [a.float() for a in (x, w1, b1, w2, b2, wp, bp)]
    x, w1, b1, w2, b2, wp, bp = args
    h2 = _conv_tiles(x, w1, b1, w2, b2, tile, rnd, acc, compute_pad,
                     window_max)
    out = _proj_tiles(h2, wp, bp, tile, rnd, acc)
    return out if exact else out.to(out_dtype)


def _math64(x, w1, b1, w2, b2, wp, bp):
    """The stem's math (`stem_ref` without its roundings) in float64."""
    def conv(h, w, b):                         # h [B, H, W, C] channels last
        pads = [tconv.same_pads(h.shape[i], 3, 2) for i in (1, 2)]
        y = F.conv2d(F.pad(h.permute(0, 3, 1, 2), (*pads[1], *pads[0])),
                     w.permute(3, 2, 0, 1), stride=2)
        return (y.permute(0, 2, 3, 1) + b).clamp(0.0, 20.0)
    x, w1, b1, w2, b2, wp, bp = (a.double() for a in (x, w1, b1, w2, b2, wp,
                                                      bp))
    h = conv(conv(x[..., None], w1, b1), w2, b2)
    B, T2, F2, d = h.shape
    return h.reshape(B, T2, F2 * d) @ wp + bp


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within_bf16(got, want):
    got, want = _np(got), _np(want)
    bound = BF16_REL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("B,T,F_,d,dout,tile", CASES, ids=IDS)
def test_schedule_float64_equals_math(B, T, F_, d, dout, tile):
    w = [torch.from_numpy(a) for a in _weights(F_, d, dout, T + d)]
    x = torch.from_numpy(_x(B, T, F_, F_))
    got = _emulate(x, *w, tile=tile, exact=True)
    want = _math64(x, *w)
    assert got.shape == want.shape == (B, T // 4, dout)
    assert float((got - want).abs().max()) <= EXACT


@pytest.mark.parametrize("B,T,F_,d,dout,tile", CASES, ids=IDS)
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_schedule_close_to_plain_and_stem_ref(B, T, F_, d, dout, tile, out):
    w = _weights(F_, d, dout, T * F_ + dout)
    x = _x(B, T, F_, T)
    tw = [torch.from_numpy(a) for a in w]
    got = _emulate(torch.from_numpy(x), *tw, tile=tile,
                   out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    assert tuple(got.shape) == (B, T // 4, dout)
    _within_bf16(got, tstem.fused_stem_plain(torch.from_numpy(x), *tw,
                                             out_dtype=getattr(torch, out)))
    _within_bf16(got, jstem.stem_ref(jnp.asarray(x),
                                     *(jnp.asarray(a) for a in w),
                                     out_dtype=getattr(jnp, out)))


@pytest.mark.parametrize("B,T,F_,d,dout,tile", [CASES[0], CASES[2]],
                         ids=[IDS[0], IDS[2]])
def test_schedule_close_to_pallas_interpret(B, T, F_, d, dout, tile):
    w = _weights(F_, d, dout, 7)
    x = _x(B, T, F_, 8)
    got = _emulate(torch.from_numpy(x), *(torch.from_numpy(a) for a in w),
                   tile=tile, out_dtype=torch.float32)
    _within_bf16(got, jstem.fused_stem(jnp.asarray(x),
                                       *(jnp.asarray(a) for a in w),
                                       interpret=True,
                                       out_dtype=jnp.float32))


@pytest.mark.parametrize("B,T,F_,d,dout,tile", CASES, ids=IDS)
def test_taps_read_h1_at_stride_two(B, T, F_, d, dout, tile):
    # every tap of every row reads region position (2 t2 + di, 2 f2 + dj),
    # the row at T/2 and the column at F/2 being the pad: index logic only
    T2, F2, T1, F1 = T // 4, F_ // 4, T // 2, F_ // 2
    rows = T2 * F2
    for m0 in range(0, rows, tile):
        ta, R = _tile(T, F_, m0, tile)
        _, idx, pad = _im2col_table(torch.zeros(T, F_), T, F_, ta, R,
                                    lambda a: a)
        where = {int(i): p for p, i in enumerate(idx)}
        assert len(where) == R * (F1 + 1)          # one position each
        for tap in range(9):
            di, dj = tap // 3, tap % 3
            got = _tap_rows(m0, tile, rows, ta, T, F_, di, dj)
            for k, pos in enumerate(got[:min(tile, rows - m0)].tolist()):
                m = m0 + k
                t2, f2 = m // F2, m % F2
                p = where[pos]
                r, c = p // (F1 + 1), p % (F1 + 1)
                assert (2 * ta + r, c) == (2 * t2 + di, 2 * f2 + dj)
                assert bool(pad[p]) == (2 * t2 + di == T1 or
                                        2 * f2 + dj == F1)


def test_pad_positions_are_zero_not_computed():
    # b1 shifted up so clip(b1 + 0) > 0: computing h1 at conv2's pad row
    # and column (instead of zeroing them) moves the output well past the
    # bound, and the schedule's zeros agree with the stem's math
    B, T, F_, d, dout = 2, 16, 8, 128, 128
    w = [torch.from_numpy(a)
         for a in _weights(F_, d, dout, 5, b1_shift=3.0)]
    x = torch.from_numpy(_x(B, T, F_, 6))
    want = _math64(x, *w)
    good = _emulate(x, *w, tile=16, exact=True)
    bad = _emulate(x, *w, tile=16, exact=True, compute_pad=True)
    assert float((good - want).abs().max()) <= EXACT
    bound = BF16_REL * max(1.0, float(want.abs().max()))
    assert float((bad - want).abs().max()) > 10 * bound


def test_region_fits_the_kernel_shared_memory():
    # conformer_l's tiles need up to R = 17 h1 rows of 41 positions, and
    # a tile's region never exceeds the R = 2 span + 3 rows the kernel
    # reserves (`region_positions` in csrc/stem.cu)
    assert max(_tile(1200, 80, m0, 128)[1] for m0 in range(0, 6000, 128)) \
        == 17
    for T, F_ in ((1200, 80), (40, 12), (16, 8), (8, 8), (1000, 16)):
        T2, F2 = T // 4, F_ // 4
        span = min(T2 - 1, (F2 - 1 + 127) // F2)
        R_max = max(_tile(T, F_, m0, 128)[1]
                    for m0 in range(0, T2 * F2, 128))
        assert R_max <= 2 * span + 3


def test_region_barrier_parities():
    # the conv1 warps fill region buffer cc % 2 for chunks 1 .. nc - 1
    # (chunk 0 is the consumers' before the loop), the consumer warps
    # release buffer cc % 2 after chunk cc; each waits for the phase that
    # the other's event completes, by its parity (csrc/stem.cu)
    for nc in (4, 5, 16, 32):
        for cc in range(1, nc):
            buf = cc & 1
            fills_before = sum(1 for c in range(1, cc) if c & 1 == buf)
            assert ((cc - 1) >> 1) & 1 == fills_before & 1
            if cc >= 2:       # the release of chunk cc - 2, the buffer's
                k = sum(1 for c in range(cc - 2) if c & 1 == buf)
                assert ((cc >> 1) - 1) & 1 == k & 1


# (B, T, F, d, dout): conv2's columns in two windows of 16, two of 20 and
# six of 21 or 22 (past F = 96, the most one window holds)
WIDE = [(1, 8, 128, 128, 128), (1, 12, 160, 128, 128),
        (1, 8, 512, 128, 128)]
WIDE_IDS = ["F128", "F160", "F512"]


@pytest.mark.parametrize("B,T,F_,d,dout", WIDE, ids=WIDE_IDS)
def test_windowed_schedule_float64_equals_math(B, T, F_, d, dout):
    assert len(_windows(F_)) > 1
    w = [torch.from_numpy(a) for a in _weights(F_, d, dout, F_)]
    x = torch.from_numpy(_x(B, T, F_, T + F_))
    got = _emulate(x, *w, exact=True)
    assert float((got - _math64(x, *w)).abs().max()) <= EXACT


@pytest.mark.parametrize("B,T,F_,d,dout", WIDE, ids=WIDE_IDS)
def test_windowed_schedule_close_to_stem_ref_and_pallas(B, T, F_, d, dout):
    w = _weights(F_, d, dout, F_ + 1)
    x = _x(B, T, F_, F_ + 2)
    got = _emulate(torch.from_numpy(x), *(torch.from_numpy(a) for a in w),
                   out_dtype=torch.float32)
    jw = [jnp.asarray(a) for a in w]
    _within_bf16(got, jstem.stem_ref(jnp.asarray(x), *jw,
                                     out_dtype=jnp.float32))
    _within_bf16(got, jstem.fused_stem(jnp.asarray(x), *jw, interpret=True,
                                       out_dtype=jnp.float32))


def test_f2_windows_bound_the_region():
    # every F2 is cut into consecutive windows of 2 .. WINDOW_MAX columns,
    # and no tile of any window, at any T, holds more than REGION_MAX
    # region positions: the conv kernel's shared memory does not depend
    # on F (or T)
    assert _windows(80) == [(0, 20)]                 # conformer_l: as before
    assert _windows(128) == [(0, 16), (16, 16)]
    assert [fw for _, fw in _windows(512)] == [22, 22, 21, 21, 21, 21]
    for F2 in range(2, 1025):
        ws = _windows(4 * F2)
        assert [fa for fa, _ in ws] == [0] + list(
            np.cumsum([fw for _, fw in ws])[:-1])
        assert sum(fw for _, fw in ws) == F2
        assert all(2 <= fw <= tstem.WINDOW_MAX for _, fw in ws)
    most = 0
    for fw in range(2, tstem.WINDOW_MAX + 1):
        for T in (8, 12, 1200, 4096):
            rows = T // 4 * fw
            most = max(most, max(_tile(T, 4 * fw, m0, 128, fw)[1] *
                                 (2 * fw + 1) for m0 in range(0, rows, 128)))
    # (the kernel's bound, (2 span + 3) (2 fw + 1) with span the most t2
    # rows a tile of 128 can cross, is not always reached at m0 % 128 = 0)
    assert 697 < most <= REGION_MAX
