"""The persistent recurrence kernels' schedules (`csrc/rnn_scan.cu`,
`csrc/lstm_scan.cu`), emulated in PyTorch on the CPU, against the port's
plain versions and the JAX package's `rnn_scan_pallas_raw` /
`lstm_scan_pallas_raw` in interpret mode.

The emulations follow the kernels' decomposition step by step.
  Elman (`emulate_rnn`): the wrapper's `plan` (H padded to a multiple of
  128, G clusters of NU units, chunks of MB rows) at a given number of
  co-resident clusters; bf16 h0 written into slot 0 of a two-slot
  ping-pong buffer; at step s every block (cluster g, rank r) multiplies
  the chunk's rows of slot s % 2, its K slice [r Kb, (r + 1) Kb), by its
  resident bf16 W^T slice, warp by warp (MB / 32 rows of warps, each the
  n8 tiles the kernel gives it), into a partial tile that starts as NaN
  (what a tile element no warp writes would hold); the cluster sums the 8
  partial tiles in rank order, each block its MB / 8 rows by the
  kernel's thread map (which must cover every real row and unit quad
  once), adds xw[t] (whose L2 prefetch was issued during step s - 1),
  applies tanh and writes out[t] and bf16 h_t into slot (s + 1) % 2.
  LSTM (`emulate_lstm`): the wrapper's `plan` (H padded to 16, batch
  groups of RB rows) at a given number of co-resident groups a unit
  tile; block (unit tile j, y, direction d) holds the four gate column
  slices g H + [16 j, 16 j + 16) of bf16 W^T, walks the groups y, y + GY,
  ..., keeps c of its (row, unit) pairs from c0 to the end (in registers
  for one group, parked in cbuf between steps for several), and
  multiplies a chunk of 32 rows of slot s % 2 in four K quarters, summed
  ((q0 + q1) + (q2 + q3)); the cell writes out[t] and bf16 h_t into slot
  (s + 1) % 2.
  Elman, streamed (`emulate_stream`, past the resident limit): the
  wrapper's `stream_plan` at a given number of co-resident blocks; the
  prologue's bf16 W_hh scratch [Hp, Hp] (zero padded) and bf16 h0 in slot
  0; at step s block (gb0, gn) walks its batch tiles gb0, gb0 + gBr, ..;
  for each it streams K in stages of 128 from its own first stage
  (gn * stages // gN, then around; the h tile of slot s % 2, zero past B,
  and the W tile of its NU units), each of the WGK K slices of a
  stage into a partial tile of its own (slice 0's starts from xw[t]; the
  warps of the `warp_grid` cover every m16 x n8 tile of the block once a
  slice), sums the partial tiles in K order, applies tanh and writes
  out[t] and bf16 h_t into slot (s + 1) % 2.
Blocks run one after another inside a step, so a schedule that reads the
slot it is writing sees some units of h_t in place of h_{t-1}: the
`read_write_slot` variants must fail (a case checks that they do).

Tolerances:
  CLOSE_MAX  2e-3, max |emulation - reference| over a few steps: both
             round h to bf16 for the product (2^-8 relative) after float32
             sums in another order, which can flip a rounding now and then;
             a flip moves the next steps by up to ~1e-3 at these widths.
  CLOSE_MEAN 1e-5, the mean |difference|: the flips are rare (one moves a
             few hundred elements by ~1e-3), the rest is float32 summation
             order (~1e-8).
  WRONG      0.05: the slot-reading bug moves h by O(0.1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu.ops.pallas.lstm_scan import lstm_scan_pallas_raw
from gasr_tpu.ops.pallas.rnn_scan import rnn_scan_pallas_raw

from gasr_tpu_torch.ops.cuda import lstm_scan as tlstm
from gasr_tpu_torch.ops.cuda import rnn_scan as trnn

CLOSE_MAX = 2e-3
CLOSE_MEAN = 1e-5
WRONG = 0.05
CLUSTERS = 15          # clusters of 8 an H100 holds at once (one block an SM)


def _rnn_smem(NU, Kb, MB):
    """`rnn_scan_smem` of csrc/rnn_scan.cu: W^T, the staged chunk, P."""
    return NU * (Kb + 8) * 2 + MB * (Kb + 8) * 2 + MB * (NU + 4) * 4


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _warp_tiles(NU, nu, MB):
    """The kernel's warps over a block's partial tile: (wm, first n8 tile,
    n8 tiles) of each of the 16 warps, MB / 32 rows of them."""
    nwn = 16 // (MB // 32)
    ntiles = nu // 8
    ntw = -(-(NU // 8) // nwn)
    NTW = next(n for n in (2, 4, 6) if ntw <= n)   # the instantiation
    for wm in range(MB // 32):
        for wn in range(nwn):
            nt_w = ntiles // nwn + (wn < ntiles % nwn)
            assert nt_w <= NTW
            yield wm, wn * (ntiles // nwn) + min(wn, ntiles % nwn), nt_w


def _sum_map(nu, MB, real_rows):
    """The (row, unit quad) each thread of each rank sums (kXPer = 2
    elements a thread): must cover every real row and quad exactly once."""
    RR, nq = MB // trnn.CLUSTER, nu // 4
    seen = []
    for rank in range(trnn.CLUSTER):
        e = torch.arange(2 * 512)
        e = e[e < RR * nq]
        row = rank * RR + e // nq
        keep = row < real_rows
        seen += list(zip(row[keep].tolist(), (e % nq)[keep].tolist()))
    assert sorted(seen) == [(r, q) for r in range(real_rows)
                            for q in range(nq)]


def emulate_rnn(xw, w, h0, reverse=False, clusters=CLUSTERS, smem=_rnn_smem,
                read_write_slot=False):
    T, B, H = xw.shape
    Hp, NU, G, MB = trnn.plan(H, smem, lambda *_: clusters)
    Kb = Hp // trnn.CLUSTER
    wt = torch.zeros(Hp, Hp)
    wt[:H, :H] = _bf16(w)                     # resident slices, zero padded
    hbf = torch.zeros(2, B, Hp)
    hbf[0, :, :H] = _bf16(h0)                 # the prologue: slot 0
    out = torch.empty(T, B, H)
    prefetched = {0}                          # steps whose xw is in L2
    for s in range(T):
        t = T - 1 - s if reverse else s
        assert s in prefetched, "xw read before its prefetch"
        if s + 1 < T:
            prefetched.add(s + 1)             # issued during step s
        read = (s + 1) % 2 if read_write_slot else s % 2
        for c in range(-(-B // MB)):
            rows = slice(c * MB, min(B, (c + 1) * MB))
            nr = rows.stop - rows.start
            for g in range(G):
                n0, n1 = g * NU, min(Hp, (g + 1) * NU)
                _sum_map(n1 - n0, MB, nr)
                P = torch.full((trnn.CLUSTER, MB, NU), float("nan"))
                for r in range(trnn.CLUSTER):
                    k = slice(r * Kb, (r + 1) * Kb)
                    hs = torch.zeros(MB, Kb)     # rows past B staged as 0
                    hs[:nr] = hbf[read, rows, k]
                    for wm, j0, nt_w in _warp_tiles(NU, n1 - n0, MB):
                        if c * MB + wm * 32 < B:  # a warp with a real row
                            m, u = slice(wm * 32, wm * 32 + 32), \
                                slice(8 * j0, 8 * (j0 + nt_w))
                            P[r, m, u] = hs[m] @ wt[k, n0 + u.start:
                                                    n0 + u.stop]
                total = P[0]
                for r in range(1, trnn.CLUSTER):   # in rank order
                    total = total + P[r]
                total = total[:nr, :n1 - n0]
                x = torch.zeros_like(total)
                m = min(n1, H) - n0
                if m > 0:
                    x[:, :m] = xw[t, rows, n0:n0 + m]
                h = torch.tanh(x + total)
                if m > 0:
                    out[t, rows, n0:n0 + m] = h[:, :m]
                hbf[(s + 1) % 2, rows, n0:n1] = _bf16(h)
    return out


def emulate_lstm(xws, ws, h0, c0, reverse, read_write_slot=False,
                 resident=None):
    D = len(xws)
    T, B, H4 = xws[0].shape
    H = H4 // 4
    Hp, RB, groups = tlstm.plan(B, H)
    GY = groups if resident is None else min(groups, resident)
    UB, MB = tlstm.UNITS, tlstm.ROWS
    n16 = Hp // 16
    per = -(-n16 // 4)
    quarters = [slice(16 * min(q * per, n16), 16 * min(q * per + per, n16))
                for q in range(4)]
    out = torch.empty(T, B, D * H)
    for d in range(D):
        wt = torch.zeros(Hp, 4 * Hp)          # gate g of unit j at g Hp + j
        for g in range(4):
            wt[:H, g * Hp:g * Hp + H] = _bf16(ws[d][:, g * H:(g + 1) * H])
        hbf = torch.zeros(2, B, Hp)
        hbf[0, :, :H] = _bf16(h0)
        # c of each block's pairs: in registers where a block holds one
        # group, in cbuf (NaN where no pair of a block was ever put) where
        # it walks several and parks the c of the group it leaves
        multi = GY < groups
        cbuf = torch.full((B, Hp), float("nan"))
        c_reg = {}
        for j0 in range(0, Hp, UB):
            for r0 in range(0, B, RB):
                c = torch.zeros(min(RB, B - r0), UB)
                m = max(0, min(UB, H - j0))
                c[:, :m] = c0[r0:r0 + RB, j0:j0 + m]
                if multi:
                    cbuf[r0:r0 + RB, j0:j0 + UB] = c
                else:
                    c_reg[j0, r0] = c
        for s in range(T):
            t = T - 1 - s if reverse[d] else s
            read = (s + 1) % 2 if read_write_slot else s % 2
            for j0 in range(0, Hp, UB):
                cols = torch.cat([torch.arange(g * Hp + j0, g * Hp + j0 + UB)
                                  for g in range(4)])
                m = max(0, min(UB, H - j0))
                walks = [range(y, groups, GY) for y in range(GY)]
                for r0 in (gi * RB for walk in walks for gi in walk):
                    if multi:                     # back from cbuf
                        c_reg[j0, r0] = cbuf[r0:r0 + RB, j0:j0 + UB].clone()
                    for c0_ in range(r0, min(B, r0 + RB), MB):
                        rows = slice(c0_, min(B, r0 + RB, c0_ + MB))
                        p = [hbf[read, rows, q] @ wt[q][:, cols]
                             for q in quarters]
                        tile = (p[0] + p[1]) + (p[2] + p[3])
                        x = torch.zeros_like(tile)
                        for g in range(4):
                            x[:, g * UB:g * UB + m] = \
                                xws[d][t, rows, g * H + j0:g * H + j0 + m]
                        pre = x + tile
                        i, f, gg, o = pre.split(UB, dim=1)
                        cr = c_reg[j0, r0][c0_ - r0:c0_ - r0 + pre.shape[0]]
                        cr[:] = torch.sigmoid(f) * cr + torch.sigmoid(i) * \
                            torch.tanh(gg)
                        h = torch.sigmoid(o) * torch.tanh(cr)
                        out[t, rows, d * H + j0:d * H + j0 + m] = h[:, :m]
                        hbf[(s + 1) % 2, rows, j0:j0 + UB] = _bf16(h)
                    if multi:                     # parked for the next step
                        cbuf[r0:r0 + RB, j0:j0 + UB] = c_reg.pop((j0, r0))
    return out


def _close(got, want):
    diff = (got - want).abs()
    assert float(diff.max()) <= CLOSE_MAX, float(diff.max())
    assert float(diff.mean()) <= CLOSE_MEAN, float(diff.mean())


def _rnn_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((T, B, H)) * 0.5).astype(np.float32),
            (rng.uniform(-1, 1, (H, H)) / H ** 0.5).astype(np.float32),
            np.tanh(rng.standard_normal((B, H))).astype(np.float32))


@pytest.mark.parametrize("T,B,H,reverse,clusters", [
    (6, 70, 200, False, CLUSTERS),  # B off the 128-row chunk, H 200 -> 256
    (5, 130, 128, True, CLUSTERS),  # two chunks, the last of 2 rows
    (4, 3, 1000, False, 6),         # 6 clusters of 176 units (Hp = 1024)
])
def test_rnn_schedule_matches_plain_and_jax(T, B, H, reverse, clusters):
    xw, w, h0 = _rnn_inputs(T, B, H, T + B + H)
    got = emulate_rnn(torch.from_numpy(xw), torch.from_numpy(w),
                      torch.from_numpy(h0), reverse, clusters)
    plain = trnn.rnn_scan_plain(torch.from_numpy(xw), torch.from_numpy(w),
                                torch.from_numpy(h0), reverse)
    jax_out = torch.from_numpy(np.array(rnn_scan_pallas_raw(
        jnp.asarray(xw), jnp.asarray(w), jnp.asarray(h0), reverse=reverse,
        interpret=True)))
    _close(got, plain)
    _close(got, jax_out)


def test_rnn_schedule_with_64_row_chunks():
    # where 128-row chunks do not fit in shared memory the plan takes 64
    T, B, H = 4, 100, 256
    xw, w, h0 = (torch.from_numpy(a) for a in _rnn_inputs(T, B, H, 3))

    def smem(NU, Kb, MB):
        return _rnn_smem(NU, Kb, MB) + (trnn.SMEM_MAX if MB == 128 else 0)
    assert trnn.plan(H, smem, lambda *_: CLUSTERS)[3] == 64
    _close(emulate_rnn(xw, w, h0, smem=smem),
           trnn.rnn_scan_plain(xw, w, h0))


def test_rnn_schedule_reading_the_slot_it_writes_fails():
    T, B, H = 5, 70, 200
    xw, w, h0 = (torch.from_numpy(a) for a in _rnn_inputs(T, B, H, 11))
    plain = trnn.rnn_scan_plain(xw, w, h0)
    bad = emulate_rnn(xw, w, h0, read_write_slot=True)
    assert float((bad - plain).abs().max()) > WRONG


def test_rnn_plan():
    # reference_large on an H100 (15 clusters of 8 at one block an SM)
    assert trnn.plan(2048, _rnn_smem, lambda *_: 15) == (2048, 144, 15,
                                                          128)
    # padded units: the last cluster holds the rest
    Hp, NU, G, MB = trnn.plan(200, _rnn_smem, lambda *_: 15)
    assert (Hp, NU, G, MB) == (256, 24, 11, 128) and (G - 1) * NU < Hp
    # past 2048, chunks of 64 rows; the resident limit at 2688
    assert trnn.plan(2560, _rnn_smem, lambda *_: 15)[3] == 64
    assert trnn.plan(2688, _rnn_smem, lambda *_: 15) is not None
    # past shared memory: no plan
    assert trnn.plan(2816, _rnn_smem, lambda *_: 15) is None
    assert trnn.plan(4096, _rnn_smem, lambda *_: 15) is None


def _lstm_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((T, B, 4 * H)) * 0.5).astype(np.float32),
            (rng.uniform(-1, 1, (H, 4 * H)) / H ** 0.5).astype(np.float32),
            np.tanh(rng.standard_normal((B, H))).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("T,B,H,reverse,resident", [
    (6, 40, 40, False, None),    # B off the 32-row chunk, H 40 -> 48
    (5, 5, 96, True, None),      # a chunk of 5 rows
    (4, 150, 64, False, None),   # two batch groups of 96 rows (three chunks)
    (4, 300, 32, True, 2),       # three groups of 100 on two blocks a tile
])
def test_lstm_schedule_matches_plain_and_jax(T, B, H, reverse, resident):
    xw, w, h0, c0 = _lstm_inputs(T, B, H, T + B + H)
    tt = [torch.from_numpy(a) for a in (xw, w, h0, c0)]
    got = emulate_lstm([tt[0]], [tt[1]], tt[2], tt[3], [reverse],
                       resident=resident)
    plain = tlstm.lstm_scan_plain(*tt, reverse=reverse)
    jax_out = torch.from_numpy(np.array(lstm_scan_pallas_raw(
        *(jnp.asarray(a) for a in (xw, w, h0, c0)), reverse=reverse,
        interpret=True)))
    _close(got, plain)
    _close(got, jax_out)


def test_lstm_schedule_two_directions_equal_two_calls():
    T, B, H = 5, 24, 40
    xf, wf, h0, c0 = (torch.from_numpy(a) for a in _lstm_inputs(T, B, H, 1))
    xb, wb, _, _ = (torch.from_numpy(a) for a in _lstm_inputs(T, B, H, 2))
    both = emulate_lstm([xf, xb], [wf, wb], h0, c0, [False, True])
    fwd = emulate_lstm([xf], [wf], h0, c0, [False])
    rev = emulate_lstm([xb], [wb], h0, c0, [True])
    assert torch.equal(both, torch.cat([fwd, rev], -1))
    _close(both, tlstm.lstm_scan_bidir(xf, xb, wf, wb, h0, c0))


def test_lstm_schedule_reading_the_slot_it_writes_fails():
    T, B, H = 5, 24, 40
    tt = [torch.from_numpy(a) for a in _lstm_inputs(T, B, H, 7)]
    plain = tlstm.lstm_scan_plain(*tt)
    bad = emulate_lstm([tt[0]], [tt[1]], tt[2], tt[3], [False],
                       read_write_slot=True)
    assert float((bad - plain).abs().max()) > WRONG


def test_lstm_plan():
    assert tlstm.plan(32, 512) == (512, 32, 1)       # deepspeech2
    assert tlstm.plan(16, 256) == (256, 32, 1)       # bilstm_2x256
    assert tlstm.plan(150, 40) == (48, 96, 2)
    assert tlstm.plan(1, 1) == (16, 32, 1)


def _stream_warps(MB, nu, WGM, WGN, WGK):
    """The streamed kernel's warps over a block's tile: every (m16, n8)
    tile covered once in each K slice, at most 2 m16 and STREAM_NTW n8
    tiles a warp (its accumulators)."""
    MT, ntiles = MB // 16 // WGM, nu // 8
    assert 1 <= MT <= 2 and WGM * WGN * WGK == trnn.STREAM_WARPS
    for kw in range(WGK):
        seen = []
        for wm in range(WGM):
            for wn in range(WGN):
                nt_w = ntiles // WGN + (wn < ntiles % WGN)
                j0 = wn * (ntiles // WGN) + min(wn, ntiles % WGN)
                assert nt_w <= trnn.STREAM_NTW
                seen += [(wm * MT + m, j0 + i) for m in range(MT)
                         for i in range(nt_w)]
        assert sorted(seen) == [(m, j) for m in range(MB // 16)
                                for j in range(ntiles)]


def emulate_stream(xw, w, h0, reverse=False, blocks=132,
                   read_write_slot=False):
    T, B, H = xw.shape
    Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S = trnn.stream_plan(B, H,
                                                                 blocks)
    assert gBr * gN <= blocks and S >= 2
    K, KW = trnn.STREAM_K, trnn.STREAM_K // WGK
    wbf = torch.zeros(Hp, Hp)
    wbf[:H, :H] = _bf16(w)                    # the prologue's scratch
    hbf = torch.zeros(2, B, Hp)
    hbf[0, :, :H] = _bf16(h0)
    out = torch.full((T, B, H), float("nan"))
    prefetched = {0}
    for s in range(T):
        t = T - 1 - s if reverse else s
        assert s in prefetched, "xw read before its prefetch"
        if s + 1 < T:
            prefetched.add(s + 1)             # issued before the barrier
        read = (s + 1) % 2 if read_write_slot else s % 2
        for gb0 in range(gBr):
            for gn in range(gN):
                n0 = gn * NU
                nu = min(NU, Hp - n0)
                _stream_warps(MB, nu, WGM, WGN, WGK)
                for gb in range(gb0, gB, gBr):
                    b0 = gb * MB
                    nr = min(MB, B - b0)
                    part = torch.zeros(WGK, MB, nu)
                    m = max(0, min(nu, H - n0))
                    part[0, :nr, :m] = xw[t, b0:b0 + nr, n0:n0 + m]
                    nk = Hp // K
                    for k in range(nk):       # the ring's stages in order,
                        k = (gn * nk // gN + k) % nk   # from the block's own
                        hs = torch.zeros(MB, K)
                        hs[:nr] = hbf[read, b0:b0 + nr, k * K:(k + 1) * K]
                        ws = wbf[k * K:(k + 1) * K, n0:n0 + nu]
                        for kw in range(WGK):
                            sl = slice(kw * KW, (kw + 1) * KW)
                            part[kw] += hs[:, sl] @ ws[sl]
                    total = part[0]
                    for q in range(1, WGK):   # in K order
                        total = total + part[q]
                    h = torch.tanh(total[:nr])
                    out[t, b0:b0 + nr, n0:n0 + m] = h[:, :m]
                    hbf[(s + 1) % 2, b0:b0 + nr, n0:n0 + nu] = _bf16(h)
    assert not bool(out.isnan().any())
    return out


@pytest.mark.parametrize("T,B,H,reverse,blocks", [
    (5, 24, 256, False, 6),     # 6 unit tiles of 48 (WGK K slices)
    (4, 40, 384, True, 4),      # B off the 16-row tile, 4 of 96 units
    (3, 136, 200, False, 2),    # H 200 -> 256; two batch tiles of 128
                                # walked by one block row
    (4, 8, 1024, False, 20),    # reference-like: MB = 16, 19 blocks of 56
])
def test_stream_schedule_matches_plain_and_jax(T, B, H, reverse, blocks):
    xw, w, h0 = _rnn_inputs(T, B, H, T * B + H)
    got = emulate_stream(torch.from_numpy(xw), torch.from_numpy(w),
                         torch.from_numpy(h0), reverse, blocks)
    plain = trnn.rnn_scan_plain(torch.from_numpy(xw), torch.from_numpy(w),
                                torch.from_numpy(h0), reverse)
    jax_out = torch.from_numpy(np.array(rnn_scan_pallas_raw(
        jnp.asarray(xw), jnp.asarray(w), jnp.asarray(h0), reverse=reverse,
        interpret=True)))
    _close(got, plain)
    _close(got, jax_out)


def test_stream_schedule_reading_the_slot_it_writes_fails():
    T, B, H = 5, 24, 256
    xw, w, h0 = (torch.from_numpy(a) for a in _rnn_inputs(T, B, H, 13))
    plain = trnn.rnn_scan_plain(xw, w, h0)
    bad = emulate_stream(xw, w, h0, blocks=6, read_write_slot=True)
    assert float((bad - plain).abs().max()) > WRONG


def test_stream_plan():
    # the three shapes past the resident limit that the card runs, on an
    # H100's 132 blocks: (Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S)
    assert trnn.stream_plan(8, 2816, 132) == (2816, 16, 1, 1, 24, 118, 1, 1,
                                              8, 8)
    assert trnn.stream_plan(32, 5120, 132) == (5120, 32, 1, 1, 40, 128, 2,
                                               1, 4, 8)
    assert trnn.stream_plan(256, 4480, 132) == (4480, 128, 2, 2, 72, 63, 4,
                                                2, 1, 4)
    # a batch past the blocks' rows: block rows walk several batch tiles
    Hp, MB, gB, gBr, NU, gN = trnn.stream_plan(1024, 8192, 132)[:6]
    assert gB > gBr and gBr * gN <= 132 and gB * MB >= 1024
    # unit tiles of an odd number of n8 tiles (the kernel's W tile rows
    # fall in distinct bank groups)
    for B, H in ((8, 2816), (256, 4480), (1024, 8192), (8, 20000)):
        assert trnn.stream_plan(B, H, 132)[4] // 8 % 2 == 1


def test_design_rule_takes_a_kernel_at_every_shape():
    # resident up to its limit (2688 on an H100: 15 clusters of 8 at one
    # block an SM), streamed past it; never the plain version, never a
    # raise, at every (B, H) that JAX's rule admits
    for B in (8, 16, 256, 1024):
        for H in range(128, 12289, 128):
            kind, p = trnn.pick_design(B, H, _rnn_smem, lambda *_: CLUSTERS,
                                       132)
            assert kind == ("resident" if H <= 2688 else "streamed"), (B, H)
            if kind == "streamed":
                Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S = p
                assert gBr * gN <= 132 and gB * MB >= B and gN * NU >= Hp
                assert trnn.stream_smem(MB, NU, WGK, S) <= trnn.SMEM_MAX
                assert trnn.warp_grid(MB, NU) == (WGM, WGN, WGK)
