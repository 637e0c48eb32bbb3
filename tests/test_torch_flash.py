"""The rel-pos flash attention kernel's algorithm (`csrc/flash_mhsa.cu`),
emulated in PyTorch on the CPU, against `_rel_shift`, the port's plain
version and the JAX package's `flash_ref`.

The emulation follows the kernel's schedule: query tiles of `tile` rows
in groups of 16 (a warp's), key tiles of `tile` keys with the tiles
wholly at or past a length skipped, the position scores of group w at key
tile kt read from the product of its qv rows with the window of
tile + 16 R rows that starts at jb0 + tile kt + (tile - 16) - 16 w
(jb0 = T-1-t0-(tile-1)), at the kernel's skewed column key + 15 - row,
and the online softmax (running max and sum in float32, the accumulator
rescaled, the unnormalized probabilities rounded to bf16 before their
product with v). The kernel's rounding points: q, k, v, u, vb and R are
bf16 (R = bf16(bf16(sinusoid) @ bf16(wr))), q + u and q + vb are bf16
sums, every product sums in float32.

Tolerances:
  BAND_TOL  the band's bd against `_rel_shift`, both in float64: the same
            products, only the index arithmetic differs, so they agree
            to the last bits.
  BF16_REL  0.02 * max(1, max|ref|), the JAX package's own kernel-against-
            oracle bound (tests/test_flash_mhsa.py): R rounded to bf16
            where the reference rounds us, uc, A and B, and p~ rounded
            before the normalization, each 2^-8 relative.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gasr_tpu.ops.pallas import flash_mhsa as jflash

from gasr_tpu_torch.ops import attention as tatt
from gasr_tpu_torch.ops.cuda import flash_mhsa as tflash

BAND_TOL = 1e-9
BF16_REL = 0.02

# (B, H, T, dh, lengths, tile)
CASES = [
    # T not a multiple of 64, a length of 0, one inside key tile 1, one of 1
    (4, 2, 100, 36, (100, 0, 70, 1), 64),
    (2, 2, 2, 8, (2, 1), 64),                  # the shortest eligible T
    (3, 2, 50, 16, (50, 17, 33), 16),          # small tiles: many of each,
]                                              # tiles skipped
IDS = ["T100_dh36", "T2", "tile16"]


def _inputs(B, H, T, dh, lengths, seed):
    rng = np.random.default_rng(seed)
    D = H * dh
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
               for _ in range(3))
    wr = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
    u = (rng.standard_normal((H, dh)) * 0.1).astype(np.float32)
    vb = (rng.standard_normal((H, dh)) * 0.1).astype(np.float32)
    return q, k, v, wr, u, vb, np.asarray(lengths, np.int32)


def _r16(a):
    return a.to(torch.bfloat16).float()


def _r_table(wr, T, H, dh):
    """The wrapper's R = bf16(bf16(sinusoid) @ bf16(wr)), [2T-1, H, dh]."""
    r = torch.matmul(_r16(tatt._sinusoid_pos(T, H * dh)), _r16(wr))
    return _r16(r).reshape(2 * T - 1, H, dh)


def _window(qv_rows, R, j0, n):
    """qv rows . R[j0 .. j0 + n)^T, rows of R outside [0, 2T-1) zero."""
    idx = torch.arange(j0, j0 + n)
    ok = (idx >= 0) & (idx < R.shape[0])
    rows = torch.zeros((n,) + tuple(R.shape[1:]), dtype=R.dtype)
    rows[ok] = R[idx[ok]]
    return torch.einsum("bhtd,jhd->bhtj", qv_rows, rows)


def _skew(p16):
    """[B, H, 16, n] window products -> [B, H, 16, n - 16]: row r, key c
    reads column c + 15 - r."""
    n = p16.shape[-1] - 16
    col = torch.arange(n)[None, :] + 15 - torch.arange(16)[:, None]
    return p16.gather(-1, col.expand(p16.shape[:2] + (16, n)))


def _pad_rows(a, Tp):
    return F.pad(a, (0, 0, 0, Tp - a.shape[2]))


def _band_tile(qv, R, T, t0, kt, tile):
    """bd of query tile [t0, t0 + tile) against key tile kt, group by
    group of 16 rows, as the kernel's warps compute it."""
    jb0 = (T - 1) - t0 - (tile - 1)
    return torch.cat([
        _skew(_window(qv[:, :, t0 + 16 * w:t0 + 16 * (w + 1)], R,
                      jb0 + tile * kt + (tile - 16) - 16 * w, tile + 16))
        for w in range(tile // 16)], dim=2)


def _band_bd(qv, R, tile):
    """bd [B, H, T, T] by the kernel's band windows, every key tile."""
    B, H, T, _ = qv.shape
    n = -(-T // tile)
    qv = _pad_rows(qv, n * tile)
    bd = torch.cat([torch.cat([_band_tile(qv, R, T, qt * tile, kt, tile)
                               for kt in range(n)], dim=3)
                    for qt in range(n)], dim=2)
    return bd[:, :, :T, :T]


def _emulate(q, k, v, wr, u, vb, lengths, out_f32=False, tile=64):
    """The kernel's schedule and rounding points on the CPU."""
    B, H, T, dh = q.shape
    n = -(-T // tile)
    Tp = n * tile
    qb = _pad_rows(_r16(q), Tp)            # query rows past T are zeros
    kf, vf = _pad_rows(_r16(k), Tp), _pad_rows(_r16(v), Tp)
    qu = _r16(qb + _r16(u)[None, :, None])
    qv = _r16(qb + _r16(vb)[None, :, None])
    R = _r_table(wr, T, H, dh)
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    lens = lengths.long()
    uniform = lens <= 0                    # no valid key: average v over T
    Tk = torch.where(uniform, torch.full_like(lens, T), lens.clamp(max=T))
    nk = (Tk + tile - 1) // tile           # key tiles that hold a key
    out = torch.zeros(B, H, Tp, dh)
    for qt in range(n):
        rows = slice(qt * tile, (qt + 1) * tile)
        m_run = torch.full((B, H, tile, 1), -math.inf)
        l_run = torch.zeros(B, H, tile, 1)
        o = torch.zeros(B, H, tile, dh)
        for kt in range(int(nk.max())):
            live = (kt < nk)[:, None, None, None]
            ks = slice(kt * tile, (kt + 1) * tile)
            s = (torch.matmul(qu[:, :, rows], kf[:, :, ks].transpose(-1, -2))
                 + _band_tile(qv, R, T, qt * tile, kt, tile)) * scale
            s = torch.where(uniform[:, None, None, None], 0.0, s)
            valid = torch.arange(kt * tile, (kt + 1) * tile)[None, :] \
                < Tk[:, None]
            s = torch.where(valid[:, None, None, :], s, -math.inf)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new)
            l_new = l_run * corr + p.sum(-1, keepdim=True)
            o_new = o * corr + torch.matmul(_r16(p), vf[:, :, ks])
            m_run = torch.where(live, m_new, m_run)
            l_run = torch.where(live, l_new, l_run)
            o = torch.where(live, o_new, o)
        out[:, :, rows] = o / l_run
    out = out[:, :, :T]
    return out if out_f32 else out.to(torch.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("B,H,T,dh,lengths,tile", CASES, ids=IDS)
def test_band_bd_equals_rel_shift(B, H, T, dh, lengths, tile):
    q, _, _, wr, _, vb, _ = _inputs(B, H, T, dh, lengths, T + dh)
    qv = torch.from_numpy(q + vb[None, :, None]).double()
    R = torch.matmul(tatt._sinusoid_pos(T, H * dh).double(),
                     torch.from_numpy(wr).double()).reshape(2 * T - 1, H, dh)
    want = tatt._rel_shift(torch.einsum("bhtd,jhd->bhtj", qv, R))
    got = _band_bd(qv, R, tile)
    assert got.shape == want.shape == (B, H, T, T)
    assert float((got - want).abs().max()) <= BAND_TOL


@pytest.mark.parametrize("B,H,T,dh,lengths,tile", CASES, ids=IDS)
@pytest.mark.parametrize("out_f32", [False, True])
def test_schedule_close_to_plain_and_flash_ref(B, H, T, dh, lengths, tile,
                                               out_f32):
    ins = _inputs(B, H, T, dh, lengths, T * dh + tile)
    tins = [torch.from_numpy(a) for a in ins]
    got = _emulate(*tins, out_f32=out_f32, tile=tile)
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    assert tuple(got.shape) == (B, H, T, dh)
    refs = (tflash.flash_mhsa_rel_plain(*tins, out_f32=out_f32),
            jflash.flash_ref(*(jnp.asarray(a) for a in ins), out_f32=out_f32))
    for ref in refs:
        want = _np(ref)
        bound = BF16_REL * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(_np(got) - want).max()) <= bound


def test_band_windows_lie_in_two_chunks():
    # the kernel keeps R in a ring of three 64-row chunks: tile kt's
    # windows (rows relative to jb0) must lie in chunks kt and kt + 1
    for kt in range(20):
        for w in range(4):
            start = 64 * kt + 48 - 16 * w
            assert 64 * kt <= start and start + 80 <= 64 * (kt + 2)


def test_zero_length_schedule_averages_v():
    ins = [torch.from_numpy(a) for a in _inputs(2, 2, 100, 36, (0, 0), 5)]
    got = _emulate(*ins, out_f32=True)
    want = _r16(ins[2]).mean(2, keepdim=True).expand_as(got)
    assert float((got - want).abs().max()) <= 2.0 ** -8


def test_schedule_skips_tiles_past_the_length():
    # keys at or past the length take no part: changing them moves nothing
    # (three key tiles of 64; the first length skips the third)
    ins = [torch.from_numpy(a) for a in _inputs(2, 1, 130, 16, (65, 3), 7)]
    base = _emulate(*ins, out_f32=True)
    ins[1][:, :, 65:] += 5.0
    ins[2][:, :, 65:] -= 3.0
    torch.testing.assert_close(_emulate(*ins, out_f32=True), base, atol=0,
                               rtol=0)


@pytest.mark.parametrize("dh,H,want", [(64, 8, 8), (36, 4, 4), (10, 3, 2),
                                       (5, 2, 1)])
def test_copy_width_of_mhsa_rel_views(dh, H, want):
    # q, k, v as mhsa_rel passes them: permuted views of the [T, B, 3D]
    # qkv product, read in place when the copy width divides their strides
    T, B = 7, 3
    D = H * dh
    qkv = torch.zeros(T, B, 3 * D, dtype=torch.bfloat16)
    views = [qkv[:, :, i * D:(i + 1) * D].reshape(T, B, H, dh)
             .permute(1, 2, 0, 3) for i in range(3)]
    assert views[1].stride() == (3 * D, dh, B * 3 * D, 1)
    r = torch.zeros(2 * T - 1, D, dtype=torch.bfloat16)
    assert tflash._copy_width(dh, (*views, r)) == want


def test_pos_table_is_the_rounded_sinusoid_table():
    got = tflash._pos_table(9, 12, torch.device("cpu"))
    assert got is tflash._pos_table(9, 12, torch.device("cpu"))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, tatt._sinusoid_pos(9, 12).to(
        torch.bfloat16), atol=0, rtol=0)
