#!/usr/bin/env python3
"""Chip check of the PyTorch/H100 port (gasr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from gasr_tpu_torch/csrc, holds each against its
plain PyTorch version at the shapes of the main paths, reproduces the
golden decode fixtures through the port, and drives three paths on the
`reference_large` preset (B=256, T=200, F=78, hidden 2048, V=47, beam
100, max_len 256), counting the kernel launches of one run of each:
  - `ctc_beam_search(topk_impl="approx")` on phase 2's decode inputs, with
    and without an LM, held bit-equal to its plain version, its recall
    against the exact decode and its ms, and the decode kernel from a beam
    whose slots carry -0.0 (phase 2b);
  - `Pipeline.transcribe` with rnn_impl="pallas" (phase 6);
  - the streaming decode, `streaming_step` over the same log-probs in 10
    chunks of 20 frames, held array-equal to the batch decode, then
    `Pipeline.transcribe_streaming` and the one-shot `Pipeline.transcribe`
    with rnn_impl="scan", launches counted (phase 7);
and one path on the `conformer_l` preset (d=512, 17 blocks, 8 heads,
B=64, T=1200 -> T'=300, F=80, V=129, beam 16, max_len 256, bf16, on one
card: mesh_shape={}), as bench.py drives it: `model_apply(...,
compute_dtype="bfloat16")` then `ctc_beam_search` and `decode_to_lists`,
with the flash attention kernel (17 launches) and, with
stem_impl="pallas", the fused stem kernel (phase 8); and the two LSTM
presets through `Pipeline.transcribe` with rnn_impl="pallas" at full
size, `deepspeech2` (B=32, T=600 -> 300, F=160, two convs, 5 BiLSTM
layers of H=512, W=32) and `bilstm_2x256` (B=16, T=400, F=80, 2 BiLSTM
layers of H=256, W=10), with the LSTM recurrence kernel (one persistent
launch a layer, both directions in it: 5 and 2), after the kernel is
held to its plain version at both shapes, and small forwards of both,
card against CPU (phase 9); and audio in, text out with bigram shallow
fusion (phase 10): the decode kernel's LM variant against its plain
version at the
flagship shape (two tables, two kinds of log-probs) and at the envelope's
edges (V=129 W=64, V=255 W=64; V=256 takes the matched scan), the LM
stream of 10 x 20 frames against the batch LM decode,
`Pipeline.transcribe_audio` on `reference_large` (B=256 tone-speech
waveforms of 1.0-2.0 s; the native log-mel, cmvn off and on) with the
card's log-mel held to the native one, and `eval.evaluate_batch` with a
bigram table; and the vocab-sharded (tensor-parallel) decode on meshes
whose shards all sit on the one card (phase 11): `tp_frame` against its
plain version on every shard (the flagship decode shape at n = 4 and 1,
conformer_l's at n = 2 and 4), `tp_scan` in its cluster and push designs
at n = 1, 2, 4, 8 (flagship) and 2, 4, 8 (conformer_l) against
`fused_prefix_decode` and its plain version at T=40, timed beside row 2,
the exchange toy at n = 2, 4, 8 in both transports against its numpy
oracle, `ctc_beam_search_tp` on the reference_large log-probs with
{"model": 4} ("fused": 1 tp_scan launch, "fused_frame": 201 tp_frame
launches and, by torch.profiler, no other device kernel between the
first and the last; "xla" on 40 frames) and on conformer_l's log-probs
with its {"data": 2, "model": 4} mesh, each equal to the single-card
decode, and `streaming_step_tp` in 10 chunks of 20 frames equal to the TP
batch decode; the shapes past the earlier
kernels' limits (phase 12): the streamed Elman design, the stem at wide
F, the traceback at more shapes, and bidirectional LSTM layers past the
resident limit ((B, H, T) = (32, 1024, 300), (8, 1536, 200), (256, 2048,
200): the streamed LSTM design, one launch each, against its plain
version and timed beside cuDNN's LSTM); `python -m
gasr_tpu_torch.baseline_compat` on two configs as a subprocess (phase
13); and training at full width (phase 14, `train_phase`): the mixed
bf16 matmul's backward against float64, the grads of flash_mhsa_rel and
fused_stem through their kernel forwards bit-equal to their recompute
backwards at conformer_l's shapes, 7 steps each of reference_large
float32 (train_flagship) and conformer_l bf16 on one card
(train_conformer_l_bf16: 17 flash launches a step) on a fixed batch
with the loss falling and the launches counted, a conformer_l step
with stem_impl="pallas", and the conformer_l bf16 step through the
flash kernel held to the same step with the plain attention
(attn_impl="xla"): loss and grad norm of the first step, then
7 steps of each (and of the kernel path at a third of the learning rate)
side by side, then the CTC loss's kernel pair at conformer_l_train's
shape against the plain loop on the card, timed beside its byte bound, the
plain loop and F.ctc_loss (phase 14g, `ctc_phase`; alone: `python3
chip_smoke.py --ctc`); and multi-card training and the graft entries (phase
15, `parallel_phase`): the sharded train step (one process a card,
`train.make_sharded_train_step`) on reference_large at full width, a
world of one card bit-equal to `make_train_step` (with 4 or more cards
also {"data": 2, "model": 2} within the CPU tests' tolerance), ms a step
and peak memory, a sharded checkpoint round trip, `dryrun_multichip` over
every card (tp_frame, tp_scan, traceback, traceback_overlay launched by
its decode checks), `measure_dp_scaling` of reference_large with each
rank's launches, and with 2 or more cards the vocab-sharded decode with
one shard a card (`tp_scan`'s push design and the "fused_frame" loop,
beside all shards on one card) and the exchange toy's push transport
across the cards; and parakeet_ctc_batch's two kernels at its shapes
(phase 16, `parakeet_phase`; alone: `python3 chip_smoke.py --parakeet`):
`flash_mhsa_rel` at B = 32, T = 750, d_h = 128 and the one-card
vocab-sharded decode at V = 1025 (n = 9 shards), each against its plain
version and its bound; and the conformer block's residual add and
LayerNorm kernel (phase 17, `add_ln_phase`; alone: `python3 chip_smoke.py
--add-ln`) at both batch cells' shapes against its plain version, its
byte bound and the eager chain it replaced, then both cells' whole bf16
forwards with the kernel (6 and 5 launches a block) and with the plain
path in turns.
Any failed check raises and the script exits non-zero. It imports
nothing of JAX or of the JAX package.

Output: progress lines; then one JSON line {"kernels": [...]} with each
kernel's launches on the path that runs it (and per path), error against
its plain version, times (CUDA events after warm-up), least time on the
card (bound) and, where one PyTorch call computes the same function,
that call's time; then the card's name and power limit; then, last, the
JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the least-time bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12          # float32 / int32 outside the tensor cores

# stated tolerances
DECODE_SCORE_TOL = 1e-6    # same float32 expressions in the same order and
                           # the same CUDA libm; only a last-bit difference
                           # in expf/log1pf could show, scaled by |score|
GOLDEN_SCORE_TOL = 1e-5    # fixtures were written by XLA on a CPU, whose
                           # exp/log1p differ from CUDA's in the last bits
STREAM_LP_TOL = 1e-5       # chunked float32 forward against the one-shot
                           # one: the same ops, but each linear's GEMM has
                           # 20*256 rows instead of 200*256, so cuBLAS may
                           # block the sums differently; H100 reading
                           # 4.8e-7 (PERF.md)
STREAM_TC = 20             # frames per streaming chunk (bench.py's row)
TP_XLA_T = 40              # frames of the plain "xla" TP decode in phase
                           # 11d: its per-frame PyTorch ops (four shards'
                           # steps and the merge) make the whole T=200 slow
RNN_STEP_TOL = 1e-5        # one step from the same h: only the float32
                           # summation order (tensor cores vs cuBLAS) and
                           # tanhf differ
RNN_SCAN_TOL = 1e-2        # 200 steps: each step rounds h to bf16, so the
                           # sum-order differences flip some bf16 roundings
                           # (one ulp is 2^-8 of |h|) and the flips feed the
                           # next steps; the recurrence is contractive at this
                           # init; PERF.md gives the H100 readings over the
                           # seeds of RNN_SEEDS
RNN_SEEDS = (1, 2, 3)      # weights and inputs of the 200-step check
KERNEL_REL_TOL = 0.02      # flash attention and fused stem against their
                           # plain versions: max |kernel - plain| <=
                           # 0.02 * max(1, max|plain|) on valid rows, the
                           # JAX package's own kernel-against-oracle bound
                           # (tests/test_flash_mhsa.py, tests/test_stem.py):
                           # bf16 operands summed in another float32 order
                           # flip some bf16 roundings (us, uc, A, B, the
                           # attention; conv2's output), 2^-8 relative each
CTC_LOSS_RTOL = 1e-5       # the CTC kernel pair against the plain loop on
CTC_GRAD_ATOL = 1e-5       # the card: the same float32 expressions, the
                           # adjoints summed in another order (autograd's
                           # accumulation and scatter-add against the
                           # kernel's fixed order); tests/test_torch_ctc_loss.py
ADD_LN_H_SHARE = 1e-3      # add_ln's h against add_ln_plain's: off on at
                           # most this share of elements, by at most one
                           # bf16 step at the scale of the last add
                           # (`add_ln_h_steps`): the float32 row sums in
                           # another order move mu or var by a last bit now
                           # and then; x' bit-equal; tests/test_torch_add_ln.py
TRAIN_STEP_TOL = 5e-3      # the conformer_l bf16 train step through the
                           # flash kernel against the same step with the
                           # plain attention: loss and grad norm relative;
                           # bf16 roundings of the attention differ, and the
                           # loss and the norm average them over every
                           # frame and parameter; the CPU tests' bound for
                           # the port's bf16 step against JAX's
                           # (tests/test_torch_train.py BF16_STEP), ten times
                           # tighter than the 5% the JAX package holds its
                           # bf16 step to against float32
FWD_SEEDS = (1, 2, 3)      # weights and inputs of the small forward check
FWD_CARD_CPU_TOL = {       # small forward, card against CPU, same weights
    "scan": 1e-5,          # float32 all through (TF32 off): only the
                           # summation order differs
    "pallas": 1e-3,        # 20 recurrence steps that round h to bf16: a
                           # sum-order difference can flip one rounding
                           # (up to 2^-8 in h) and the flip reaches the
                           # log-probs through two linears; H100 runs
                           # measured 4.8e-7 without a flip, 6.9e-5 with
}
LSTM_STEP_TOL = 1e-5       # one LSTM step from the same (h, c): only the
                           # float32 summation order (tensor cores vs
                           # cuBLAS) and expf / tanhf against torch's
                           # sigmoid / tanh differ
LSTM_SCAN_TOL = 1e-2       # 300 or 400 steps: each step rounds h to bf16, so
                           # the sum-order differences flip some bf16
                           # roundings (one ulp is 2^-8 of |h|) and the flips
                           # feed the next steps through W_hh and c; the
                           # forget gate (about 1/2 at this init) damps them
                           # as tanh does in the Elman recurrence (same
                           # bound as RNN_SCAN_TOL); PERF.md gives the H100
                           # readings over LSTM_SEEDS
LSTM_SEEDS = (1, 2, 3)     # weights and inputs of the full-length checks
LOGMEL_TOL = 5e-3          # log-mel on the card (cuFFT) against the native
                           # C++ one: natural-log mel energies from two FFTs
                           # differ in the last bits, which the log magnifies
                           # in the quietest bins; tests/test_torch_frontend.py
                           # measured up to 1.2e-3 between the CPU's FFTs
FWD_LSTM_CARD_CPU_TOL = {  # small DS2 / BiLSTM forwards, card against CPU
    "scan": 1e-5,          # float32 all through (TF32 off in cuDNN's convs
                           # and cuBLAS): only the summation order differs
    "pallas": 1e-3,        # recurrence steps that round h to bf16: a
                           # sum-order difference can flip one rounding (up
                           # to 2^-8 in h) and the flip reaches the
                           # log-probs through the layers above
}


SHARDED_STEP_RTOL = 1e-5   # the sharded float32 step on {"data": 2,
                           # "model": 2} against the single-card step: loss
                           # and grad norm; the same ops summed in other
                           # orders (split products, the all-reduces); the
                           # CPU tests' bound (tests/test_torch_parallel.py)
SHARDED_PARAM_ATOL = 1e-6  # its updated params: Adam's first step moves an
                           # element by about lr = 3e-4 times g / (|g| +
                           # 1e-8), so an ulp of g moves it far less; the
                           # CPU tests' bound
ADAM_WELL_CONDITIONED = 0.99  # at full width SHARDED_PARAM_ATOL holds the
                           # params whose single-card first update is at
                           # least 0.99 lr: Adam's first step moves an
                           # element by lr g / (|g| + eps), which for a
                           # clipped grad |g| >= 99 eps changes by at most
                           # 3 times a change of g; for grads within 99 eps
                           # (1e-6) of zero, a sum-order difference of g in
                           # its last bits (relative to the large terms that
                           # cancel in it) moves the update by up to lr
                           # (1.07e-4 measured on 4 x H100, PERF.md); those
                           # are counted and reported
SHARDED_TIMED_STEPS = 3    # sharded steps timed after the first
DP_ITERS = 3               # calls a rank in measure_dp_scaling


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def train_phase(card, zero_counts, read_counts):
    """Phase 14, training on the card at full width: the mixed matmul's
    backward against a float64 reference; flash_mhsa_rel's and
    fused_stem's grads through their kernel forwards bit-equal to their
    recompute backwards (the VJPs of the plain versions) at conformer_l's
    shapes; then 7 steps each of reference_large (float32) and conformer_l
    (bf16, one card) on a fixed batch through `train.make_train_step` (the
    loss must fall and stay finite; launches counted), one conformer_l
    step with stem_impl="pallas", and the conformer_l bf16 step through
    the flash kernel against the same step with the plain attention.
    Returns (report, launches by run)."""
    import torch
    import gasr_tpu_torch.ops.linear  # noqa: F401  (the module, not the
    #                                   function the package re-exports)
    from gasr_tpu_torch.config import PRESETS
    from gasr_tpu_torch.models import model_init
    from gasr_tpu_torch.models.conformer import _preset
    from gasr_tpu_torch.ops.cuda import flash_mhsa, stem
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      synthetic_batch)
    lin = sys.modules["gasr_tpu_torch.ops.linear"]
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # 14a. the bf16 product's backward (torch.mm / bmm with out_dtype has
    # no derivative in torch; ops/linear.py's Function gives the JAX
    # transpose): float32 products of the float32 cotangent, rounded to
    # bf16 once; held to float64 products at 2^-8 of their largest
    # magnitude (half a bf16 ulp of rounding, plus float32 sums)
    mm_err = {}
    for what, a_shape, b_shape in (("mm", (64 * 300, 512), (512, 2048)),
                                   ("bmm", (64, 300, 64), (64, 64, 300))):
        a = randn(*a_shape).to(bf).requires_grad_()
        b = randn(*b_shape, scale=0.05).to(bf).requires_grad_()
        y = lin._TensorCoreMatmul.apply(a, b)
        gy = randn(*y.shape)
        ga, gb = torch.autograd.grad(y, (a, b), gy)
        with torch.no_grad():
            ra = torch.matmul(gy.double(), b.double().transpose(-1, -2))
            rb = torch.matmul(a.double().transpose(-1, -2), gy.double())
        for name, got, ref in (("a", ga, ra), ("b", gb, rb)):
            err = float((got.double() - ref).abs().max())
            tol = 2.0 ** -8 * float(ref.abs().max())
            check(got.dtype == bf and err <= tol,
                  f"_TensorCoreMatmul {what} d{name}: {err} > {tol}")
            mm_err[f"{what}_d{name}"] = err / float(ref.abs().max())
        del a, b, y, gy, ga, gb, ra, rb
    print(f"mixed bf16 matmul backward (float32 products of the float32 "
          f"cotangent, bf16 grads) against float64, error over max|ref|: "
          f"{mm_err}", flush=True)
    out["matmul_backward_rel_err"] = mm_err

    # 14b. flash_mhsa_rel's grads at conformer_l's shape (q, k, v as
    # mhsa_rel passes them: bf16 views of one qkv product; full lengths,
    # as training passes them) through the kernel forward == its recompute
    # backward, bit for bit: the backward never reads the forward's output
    B, H, T, dh = 64, 8, 300, 64
    D = H * dh
    qkv = randn(T, B, 3 * D).to(bf).requires_grad_()
    q, k, v = (qkv[:, :, i * D:(i + 1) * D].reshape(T, B, H, dh)
               .permute(1, 2, 0, 3) for i in range(3))
    wr = randn(D, D, scale=D ** -0.5).requires_grad_()
    u = randn(H, dh, scale=0.1).requires_grad_()
    vb = randn(H, dh, scale=0.1).requires_grad_()
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    g = randn(B, H, T, dh).to(bf)
    prims = (q, k, v, wr, u, vb)
    n0 = flash_mhsa.launches
    o = flash_mhsa.flash_mhsa_rel(*prims, lens)
    got = torch.autograd.grad(o, prims, g)
    check(flash_mhsa.launches == n0 + 1, "flash forward under autograd "
          "did not launch its kernel")
    with torch.no_grad():
        want = flash_mhsa.flash_mhsa_rel_vjp(*prims, lens, g)
    for name, a_, b_ in zip(("q", "k", "v", "wr", "u", "vb"), got, want):
        check(a_.dtype == b_.dtype and torch.equal(a_, b_),
              f"flash grad d{name} through the kernel differs from the "
              f"recompute backward")
    # beside it, the unchunked autograd of the plain version: the chunks
    # sum wr's, u's and vb's grads in another order (bf16 tolerance)
    whole = torch.autograd.grad(flash_mhsa.flash_mhsa_rel_plain(
        *prims, lens), prims, g)
    fl_gerr = {}
    for name, a_, b_ in zip(("q", "k", "v", "wr", "u", "vb"), got, whole):
        err = float((a_.float() - b_.float()).abs().max())
        tol = KERNEL_REL_TOL * max(1.0, float(b_.float().abs().max()))
        check(err <= tol, f"flash grad d{name}: chunked against whole "
              f"{err} > {tol}")
        fl_gerr[name] = err
    bwd_ms = cuda_events_ms(lambda: flash_mhsa.flash_mhsa_rel_vjp(
        *prims, lens, g), iters=3)
    print(f"flash_mhsa_rel grads [{B}, {H}, {T}, {dh}] through the kernel "
          f"forward == flash_mhsa_rel_vjp bit for bit (q, k, v, wr, u, vb); "
          f"against the unchunked plain autograd: max |diff| {fl_gerr}; "
          f"the recompute backward {bwd_ms:.3f} ms "
          f"({-(-(B * H * T * T * 4) // flash_mhsa._BWD_SCORE_BYTES)} "
          f"chunks) on {card}", flush=True)
    out["flash_backward"] = dict(ms=bwd_ms, grad_err_vs_unchunked=fl_gerr)
    del qkv, q, k, v, got, want, whole, o, prims

    # 14c. fused_stem's grads at conformer_l's shape through the kernels'
    # forward == its recompute backward, bit for bit (cuDNN's
    # deterministic algorithms for the comparison only)
    cfg_l = dataclasses.replace(PRESETS["conformer_l"], mesh_shape={})
    pl = model_init(cfg_l, torch.Generator().manual_seed(0))
    sw = [t.requires_grad_() for t in (
        pl["sub1"]["w"], pl["sub1"]["b"], pl["sub2"]["w"], pl["sub2"]["b"],
        pl["sub_proj"]["w"], pl["sub_proj"]["b"])]
    xs = torch.rand((64, 1200, 80), generator=gen, device=dev)
    gs = randn(64, 300, 512).to(bf)
    torch.backends.cudnn.deterministic = True
    try:
        n0 = stem.launches
        got = torch.autograd.grad(stem.fused_stem(xs, *sw), sw, gs)
        check(stem.launches == n0 + 1, "stem forward under autograd did "
              "not launch its kernels")
        with torch.no_grad():
            want = stem.fused_stem_vjp(xs, *sw, gs,
                                       needs=(False,) + (True,) * 6)[1:]
        for name, a_, b_ in zip(("w1", "b1", "w2", "b2", "wproj", "bproj"),
                                got, want):
            check(torch.equal(a_, b_), f"stem grad d{name} through the "
                  f"kernels differs from the recompute backward")
        st_bwd_ms = cuda_events_ms(lambda: stem.fused_stem_vjp(
            xs, *sw, gs, needs=(False,) + (True,) * 6), iters=2)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"fused_stem grads [64, 1200, 80] -> [64, 300, 512] through the "
          f"kernels' forward == fused_stem_vjp bit for bit (w1, b1, w2, b2, "
          f"wproj, bproj); the recompute backward {st_bwd_ms:.3f} ms "
          f"(float32 convolution backward, cuDNN deterministic) on {card}",
          flush=True)
    out["stem_backward"] = dict(ms=st_bwd_ms)
    del pl, sw, xs, gs, got, want

    # 14d. training at full width: reference_large float32 and conformer_l
    # bf16 on one card, 7 steps each on one fixed batch (params seed 0,
    # batch seed 1)
    runs = {}
    for row, preset, cd in (("train_flagship", "reference_large", None),
                            ("train_conformer_l_bf16", "conformer_l",
                             "bfloat16")):
        cfg = dataclasses.replace(PRESETS[preset], mesh_shape={})
        params = model_init(cfg, torch.Generator().manual_seed(0))
        opt = make_optimizer()
        state = opt.init(params)
        step = make_train_step(cfg, opt, compute_dtype=cd)
        batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
        steps = 7
        zero_counts()
        losses = [step(params, state, batch)[2]["loss"]
                  for _ in range(steps)]
        losses = [float(v) for v in losses]
        runs[row] = read_counts()
        # one fixed batch: Adam's early steps overshoot and come back
        # (a later loss may spike near the first; 14f shows the spike on
        # the plain attention path too, and none at a third of the
        # learning rate), so the loss falls when the median of the later
        # steps lies below the first
        check(all(np.isfinite(losses))
              and float(np.median(losses[1:])) < losses[0],
              f"{row}: losses {losses} do not fall or are not finite")
        n_flash = (_preset(cfg)["num_blocks"] * steps
                   if cfg.model == "conformer_l" else 0)
        # the CTC loss's kernel pair: a forward and a backward a step
        want_ = {"flash_mhsa_rel": n_flash, "ctc_loss": 2 * steps}
        check(all(runs[row][k] == v for k, v in want_.items())
              and sum(runs[row].values()) == sum(want_.values()),
              f"{row}: launches {runs[row]}, expected {want_}")
        out[row] = dict(losses=losses, launches=runs[row])
        print(f"{row} ({preset}, {cd or cfg.compute_dtype}, B="
              f"{cfg.batch_size}, T={cfg.seg_len}) on {card}: losses of "
              f"{steps} steps {[round(x, 4) for x in losses]}; launches "
              f"{runs[row]}", flush=True)
        del params, state, step, batch, opt
        torch.cuda.empty_cache()

    # 14e. one conformer_l step with stem_impl="pallas": the stem kernels'
    # forward and the flash kernel's under the step
    cfg = cfg_l
    params = model_init(cfg, torch.Generator().manual_seed(0))
    opt = make_optimizer()
    state = opt.init(params)
    step = make_train_step(cfg, opt, compute_dtype="bfloat16",
                           stem_impl="pallas")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
    zero_counts()
    _, _, m = step(params, state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    runs["train_conformer_l_stem_pallas"] = read_counts()
    got_ = runs["train_conformer_l_stem_pallas"]
    check(np.isfinite(loss) and got_["fused_stem"] == 1
          and got_["flash_mhsa_rel"] == 17 and got_["ctc_loss"] == 2
          and sum(got_.values()) == 20,
          f"conformer_l step with stem_impl='pallas': loss {loss}, "
          f"launches {got_}")
    first = out["train_conformer_l_bf16"]["losses"][0]
    print(f"conformer_l train step with stem_impl='pallas': loss {loss} "
          f"(the 'auto' stem's first step {first}; not gated: bf16 "
          f"roundings differ); launches {got_}", flush=True)
    del params, state, step, batch, opt
    torch.cuda.empty_cache()

    # 14f. the conformer_l bf16 step through the flash kernel against the
    # same step with the plain attention (attn_impl="xla", no kernel),
    # from 14d's params (seed 0) and fixed batch (seed 1): the
    # first step's loss and grad norm agree at TRAIN_STEP_TOL; then 7
    # steps of each path, and of the kernel path at a third of the
    # learning rate, each step's loss and grad norm (does 14d's
    # later spike come from the kernel path, or from the optimizer's
    # steps on one fixed batch?)
    def seven(attn_impl, learning_rate=3e-4):
        params = model_init(cfg, torch.Generator().manual_seed(0))
        opt = make_optimizer(learning_rate=learning_rate)
        state = opt.init(params)
        step = make_train_step(cfg, opt, compute_dtype="bfloat16",
                               attn_impl=attn_impl)
        batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
        zero_counts()
        ms = [step(params, state, batch)[2] for _ in range(7)]
        seq = [(float(m["loss"]), float(m["grad_norm"])) for m in ms]
        torch.cuda.synchronize()
        counts = read_counts()
        del params, state, step, batch, opt, ms
        torch.cuda.empty_cache()
        return seq, counts

    seq_k, counts_k = seven("auto")
    seq_x, counts_x = seven("xla")
    seq_lr, _ = seven("auto", learning_rate=1e-4)
    check(counts_k["flash_mhsa_rel"] == 7 * 17
          and counts_k["ctc_loss"] == counts_x["ctc_loss"] == 7 * 2
          and sum(counts_x.values()) == 7 * 2,
          f"conformer_l steps: kernel path launches {counts_k}, plain "
          f"attention path launches {counts_x}")
    check(all(np.isfinite(v) for seq in (seq_k, seq_x, seq_lr)
              for pair in seq for v in pair),
          f"conformer_l steps not finite: {seq_k} {seq_x} {seq_lr}")
    (loss_k, gn_k), (loss_x, gn_x) = seq_k[0], seq_x[0]
    err_loss = abs(loss_k - loss_x) / abs(loss_x)
    err_gn = abs(gn_k - gn_x) / abs(gn_x)
    check(err_loss <= TRAIN_STEP_TOL and err_gn <= TRAIN_STEP_TOL,
          f"conformer_l bf16 step through the flash kernel against the "
          f"plain attention: loss {loss_k} / {loss_x}, grad norm {gn_k} / "
          f"{gn_x} (relative {err_loss}, {err_gn} > {TRAIN_STEP_TOL})")

    def fmt(seq):
        return [(round(a, 4), round(b, 4)) for a, b in seq]

    print(f"conformer_l bf16 step, flash kernel against the plain attention "
          f"(attn_impl='xla') from the same params and batch: loss "
          f"{loss_k} / {loss_x}, grad norm {gn_k} / {gn_x}, relative "
          f"differences {err_loss:.3e} / {err_gn:.3e} (tolerance "
          f"{TRAIN_STEP_TOL}); 7 steps (loss, unclipped grad norm): kernel "
          f"{fmt(seq_k)}; plain attention {fmt(seq_x)}; kernel at lr 1e-4 "
          f"{fmt(seq_lr)} on {card}", flush=True)
    out["conformer_l_kernel_vs_plain"] = dict(
        loss=[loss_k, loss_x], grad_norm=[gn_k, gn_x],
        rel_err=[err_loss, err_gn], kernel=seq_k, plain=seq_x,
        kernel_lr_1e_4=seq_lr)
    return out, runs


def parallel_phase(card, zero_counts, read_counts, report):
    """Phase 15, multi-card training and the graft entries: the sharded
    train step (`train.make_sharded_train_step`, one process a card) on
    reference_large at full width (float32, B=256, T=200, H=2048, one fixed
    `synthetic_batch`; TF32 off, as in the ranks by default): a world of
    one card, {"data": 1, "model": 1} over NCCL, bit-equal to
    `make_train_step` from the same params and batch in loss, grad norm
    and every updated param (both first steps in torch's deterministic
    mode: by default the backward's scatter-adds are atomic and the
    single-card step differs from itself in the last bits), and with 4 or
    more cards {"data": 2, "model": 2} within the CPU tests' tolerance;
    ms a step (default mode) and peak memory of each;
    a sharded checkpoint (DCP) round trip in the same world; then
    `dryrun_multichip` over every card (launches counted: tp_frame,
    tp_scan, traceback, traceback_overlay and the decode, as its decode
    checks run them); `measure_dp_scaling` of reference_large over 1, 2,
    4 ... cards with each rank's launches (one decode and one traceback a
    call); with 2 or more cards, at the flagship decode shape, `tp_scan`
    and the "fused_frame" loop with one shard a card beside all shards on
    one card, and the exchange toy across the cards. Returns (report,
    launches by run)."""
    import tempfile
    import torch
    from gasr_tpu_torch.config import PRESETS
    from gasr_tpu_torch.decoder.beam_search import _init_beam
    from gasr_tpu_torch.graft_entry import dryrun_multichip
    from gasr_tpu_torch.models import model_init
    from gasr_tpu_torch.ops.cuda import fused_decode
    from gasr_tpu_torch.parallel import checks, distributed, scaling
    from gasr_tpu_torch.runtime._tree import tree_map
    from gasr_tpu_torch.runtime.checkpoint import (flatten_params,
                                                   load_params_dcp)
    from gasr_tpu_torch.runtime.timer import Timer
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      sharded_train_run, synthetic_batch)

    cards = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    out, runs = {"cards": cards, "host_cpus": os.cpu_count()}, {}
    print(f"phase 15 on {cards} card(s) of {card}, {os.cpu_count()} host "
          f"CPUs", flush=True)

    # 15a. the sharded step at full width against the single-card step
    cfg = dataclasses.replace(PRESETS["reference_large"], device="cpu")
    params = model_init(cfg)                        # seed 0, on the CPU
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(0))
    p1 = tree_map(lambda t: t.to(dev), params)
    opt = make_optimizer()
    st = opt.init(p1)
    step = make_train_step(dataclasses.replace(cfg, device="cuda"), opt)
    batch_d = {k: v.to(dev) for k, v in batch.items()}
    # the bit-for-bit comparison runs in torch's deterministic mode on
    # both sides: by default the backward's scatter-adds are atomic, and
    # two runs of the single-card step differ in the grads' last bits.
    # Deterministic cuBLAS asks for a fixed workspace
    # (CUBLAS_WORKSPACE_CONFIG), which ranks read as they start: the timed
    # steps run in ranks started without it, as a user's ranks would
    saved_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    _, _, m1 = step(p1, st, batch_d)
    want = {k: v.copy() for k, v in flatten_params(p1).items()}
    loss1, gn1 = float(m1["loss"]), float(m1["grad_norm"])
    torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    for _ in range(SHARDED_TIMED_STEPS):
        _, _, m = step(p1, st, batch_d)
    Timer.sync(m)
    out["single_card_ms"] = (time.perf_counter() - t0) \
        / SHARDED_TIMED_STEPS * 1e3
    del p1, st, batch_d
    torch.cuda.empty_cache()
    worlds = [(1, {"data": 1, "model": 1}, {"model": 1})]
    if cards >= 4:
        worlds.append((4, {"data": 2, "model": 2}, {"model": 4}))
    with tempfile.TemporaryDirectory(prefix="phase15_") as tmp:
        for world, shape, load_shape in worlds:
            ck = os.path.join(tmp, f"ckpt{world}")
            ranks = distributed.spawn(
                checks.run_each, world, "cuda",
                [(torch.use_deterministic_algorithms, (True,)),
                 (sharded_train_run, (cfg, shape, batch, params)),
                 (checks.checkpoint_run, (ck, params, shape, load_shape))])
            run = ranks[0][1]
            got = flatten_params(run["params"])
            if world == 1:
                check(run["loss"] == loss1 and run["grad_norm"] == gn1,
                      f"sharded step, world 1: loss {run['loss']} / grad "
                      f"norm {run['grad_norm']} against make_train_step's "
                      f"{loss1} / {gn1}")
                diff = [k for k in want if not np.array_equal(got[k],
                                                              want[k])]
                check(not diff, f"sharded step, world 1: params {diff} "
                      f"differ from make_train_step's")
                err = 0.0
            else:
                check(abs(run["loss"] - loss1) <= SHARDED_STEP_RTOL
                      * abs(loss1) and abs(run["grad_norm"] - gn1)
                      <= SHARDED_STEP_RTOL * abs(gn1),
                      f"sharded step {shape}: loss {run['loss']} / grad "
                      f"norm {run['grad_norm']} against {loss1} / {gn1}")
                # the params where the single card's first update is
                # well conditioned (ADAM_WELL_CONDITIONED), at the CPU
                # tests' bound; the rest counted and reported
                p0 = flatten_params(params)
                well = {k: np.abs(want[k] - p0[k])
                        >= ADAM_WELL_CONDITIONED * opt.learning_rate
                        for k in want}
                diff = {k: np.abs(got[k] - want[k]) for k in want}
                err = max(float(diff[k][well[k]].max(initial=0.0))
                          for k in want)
                ill = sum(int((~well[k]).sum()) for k in want)
                ill_over = sum(int((diff[k][~well[k]]
                                    > SHARDED_PARAM_ATOL).sum())
                               for k in want)
                err_ill = max(float(diff[k][~well[k]].max(initial=0.0))
                              for k in want)
                check(err <= SHARDED_PARAM_ATOL, f"sharded step {shape}: "
                      f"params with a well-conditioned first update differ "
                      f"from make_train_step's by {err}")
                n_params = sum(v.size for v in want.values())
                ill_eps = ADAM_WELL_CONDITIONED / (1
                                                   - ADAM_WELL_CONDITIONED)
                print(f"sharded step {shape}: of {n_params} params, {ill} "
                      f"have a single-card "
                      f"first update under {ADAM_WELL_CONDITIONED} lr (a "
                      f"clipped grad within {ill_eps:.0f} eps of zero); "
                      f"{ill_over} "
                      f"of them differ by more than {SHARDED_PARAM_ATOL}, "
                      f"at most {err_ill}", flush=True)
            whole = flatten_params(load_params_dcp(
                ck, tree_map(torch.zeros_like, params)))
            check(all(r[2]["equal"] for r in ranks)
                  and all(np.array_equal(whole[k], w)
                                       for k, w in flatten_params(
                                           params).items()),
                  f"sharded checkpoint {shape} -> {load_shape}: the loaded "
                  f"params differ from the saved ones")
            out[f"world{world}"] = dict(
                mesh=run["mesh"], loss=run["loss"], loss_1card=loss1,
                grad_norm=run["grad_norm"], grad_norm_1card=gn1,
                max_param_err=err)
            print(f"sharded train step {shape} (reference_large, float32, "
                  f"B=256) on {card}: loss {run['loss']:.6f} (one card "
                  f"{loss1:.6f}), grad norm {run['grad_norm']:.6f} "
                  f"({gn1:.6f}), max |param - one card's| {err}"
                  + (" (bit-equal)" if world == 1 else "")
                  + f" (deterministic mode); checkpoint {shape} -> "
                  f"{load_shape} and into one process whole: bit-equal",
                  flush=True)
    if saved_ws is None:
        del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_ws
    for world, shape, _ in worlds:
        timed = distributed.spawn(sharded_train_run, world, "cuda", cfg,
                                  shape, batch, params,
                                  SHARDED_TIMED_STEPS)[0]
        out[f"world{world}"].update(ms_per_step=timed["ms_per_step"],
                                    peak_gb=timed["peak_bytes"] / 1e9)
        print(f"sharded train step {shape} on {card}: "
              f"{timed['ms_per_step']:.3f} ms a step (host clock, "
              f"{SHARDED_TIMED_STEPS} steps after the first, between "
              f"barriers; make_train_step {out['single_card_ms']:.3f}), "
              f"peak {timed['peak_bytes'] / 1e9:.2f} GB a rank", flush=True)

    # 15b. dryrun_multichip over every card, its launches counted
    zero_counts()
    dryrun_multichip(cards)
    torch.cuda.synchronize()
    runs["dryrun"] = read_counts()
    for name in ("fused_prefix_decode", "traceback", "traceback_overlay",
                 "tp_frame", "tp_scan"):
        check(runs["dryrun"][name] > 0, f"dryrun_multichip({cards}) "
              f"launched no {name}: {runs['dryrun']}")
    print(f"dryrun_multichip({cards}) on {card}: OK; launches "
          f"{ {k: v for k, v in runs['dryrun'].items() if v} }", flush=True)

    # 15c. data-parallel serving across the cards (one rank a card)
    counts = [n for n in (1, 2, 4, 8) if n <= cards]
    rows = scaling.measure_dp_scaling(
        dataclasses.replace(PRESETS["reference_large"], device="cuda"),
        counts, iters=DP_ITERS, decode=True)
    dp_total = {}
    for r in rows:
        for rank, launches in enumerate(r["launches"]):
            check(launches.get("fused_prefix_decode") == r["calls"]
                  and launches.get("traceback") == r["calls"],
                  f"measure_dp_scaling n={r['devices']} rank {rank}: "
                  f"launches {launches} in {r['calls']} calls (one decode "
                  f"and one traceback a call)")
            for k, v in launches.items():
                dp_total[k] = dp_total.get(k, 0) + v
    runs["dp_scaling"] = {k: dp_total.get(k, 0) for k in runs["dryrun"]}
    out["dp_scaling"] = [{k: r[k] for k in ("devices", "global_batch",
                                            "iter_s", "audio_s_per_s",
                                            "efficiency")} for r in rows]
    print(f"measure_dp_scaling reference_large (B=256 a card, forward + "
          f"decode, {DP_ITERS} calls) on {card}: " + "; ".join(
              f"{r['devices']} card(s) {r['iter_s'] * 1e3:.3f} ms, "
              f"{r['audio_s_per_s']:.1f} audio-s/s, efficiency "
              f"{r['efficiency']:.4f}" for r in rows), flush=True)

    # 15d. the vocab-sharded decode with one shard a card: tp_scan's push
    # design beside all shards on one card (both designs), the
    # "fused_frame" loop across the cards, and the exchange toy's push
    # transport across the cards; each bit-equal to one card's
    if cards >= 2:
        from gasr_tpu_torch.ops.cuda import exchange_probe
        rng = np.random.default_rng(15)
        z = rng.standard_normal((200, 256, 47)).astype(np.float32)
        lp = torch.from_numpy(z - np.log(np.exp(z).sum(-1, keepdims=True))
                              ).to(dev)
        init = fused_decode.pack_state(_init_beam(256, 100, dev))
        n = min(4, cards)
        spread = [torch.device("cuda", i) for i in range(n)]
        fins0, ys0 = fused_decode.tp_scan(lp, init, [dev] * n,
                                          design="cluster")
        runs15 = {
            "one card, cluster": lambda: fused_decode.tp_scan(
                lp, init, [dev] * n, design="cluster"),
            "one card, push": lambda: fused_decode.tp_scan(
                lp, init, [dev] * n, design="push"),
            f"{n} cards, push": lambda: fused_decode.tp_scan(lp, init,
                                                            spread),
            f"'fused_frame' {n} cards": lambda: fused_decode.tp_frames(
                lp, init, spread),
            "'fused_frame' one card": lambda: fused_decode.tp_frames(
                lp, init, [dev] * n)}
        for key, fn in runs15.items():
            got = fn()
            for d in spread:
                torch.cuda.synchronize(d)
            fins_ = [got[0]] if "fused_frame" in key else list(got[0])
            check(torch.equal(got[1], ys0) and all(
                torch.equal(f_, fins0[0]) for f_ in fins_),
                  f"TP decode {key} (n={n}) differs from all on one card")
        keys_t = np.sort(rng.integers(-1000, 1000, (n, 6, 256, 128)),
                         axis=-1)[..., ::-1].astype(np.int32).copy()
        zero_counts()
        toy = exchange_probe.toy_exchange_scan(torch.from_numpy(keys_t).to(
            dev), n, devices=spread)
        for d in spread:
            torch.cuda.synchronize(d)
        runs["toy_across_cards"] = read_counts()
        want_t = exchange_probe.toy_exchange_oracle(keys_t)
        check(runs["toy_across_cards"]["toy_exchange"] == n and all(
            np.array_equal(toy[s_].cpu().numpy(), want_t) for s_ in range(n)),
            f"toy_exchange push across {n} cards differs from the oracle")

        def host_ms(fn, iters=3):
            fn()
            for d in spread:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            for d in spread:
                torch.cuda.synchronize(d)
            return (time.perf_counter() - t0) / iters * 1e3

        ms = {k: [] for k in runs15}
        for key in list(runs15) + list(reversed(runs15)):      # in turns
            ms[key].append(host_ms(runs15[key]))
        out["tp_scan_cards"] = {k: min(v) for k, v in ms.items()}
        report["tp_scan"][f"ms_n{n}_by_cards"] = out["tp_scan_cards"]
        print(f"TP decode T=200 B=256 V=47 W=100 n={n} on {card}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out["tp_scan_cards"].items())
            + " (host clock around 3 calls and every card's fence, best of 2 "
            f"turns); all bit-equal; the toy's push transport across {n} "
            "cards == the oracle", flush=True)
    return out, runs


def tp_profile_run(T, B, V, W, L):
    """The "fused_frame" TP decode's device kernels (n = 4 on cuda:0) in
    time order and the single tp_frame call's device time, by
    torch.profiler in a child process (this script run with --tp-profile),
    which the caller waits for. Returns its JSON report."""
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--tp-profile",
         json.dumps([T, B, V, W, L])], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"the profiler's process failed: "
          f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def tp_profile_main(T, B, V, W, L) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gasr_tpu_torch.decoder.beam_search import _init_beam
    from gasr_tpu_torch.ops.cuda import fused_decode
    from gasr_tpu_torch.parallel import decode_tp, make_mesh
    dev = torch.device("cuda", 0)
    z = np.random.default_rng(11).standard_normal((T, B, V))
    z = z - z.max(-1, keepdims=True)
    lp = torch.from_numpy((z - np.log(np.exp(z).sum(-1, keepdims=True)))
                          .astype(np.float32)).to(dev)
    mesh = make_mesh({"model": 4}, devices=[dev] * 4)

    def decode():
        return decode_tp.ctc_beam_search_tp(lp, beam_width=W, mesh=mesh,
                                            max_len=L, tp_impl="fused_frame")

    decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                key=lambda e: e.time_range.start)
    idx = [i for i, e in enumerate(ev) if "tp_frame_kernel" in e.name]
    between = ev[idx[0]:idx[-1] + 1] if idx else []
    us = [e.time_range.elapsed_us() for e in between]
    # the JAX-shaped single frame: one window of the flagship's n = 4
    beam, _ = fused_decode.fused_prefix_decode(lp[:5], _init_beam(B, W, dev))
    st = fused_decode.pack_state(beam)
    f = lp[5]
    lo, hi = fused_decode.shard_bounds(V, 4)[1]
    args = (f[:, lo:hi], torch.gather(f, 1, st[4].long().clamp(0, V - 1)),
            f[:, 0].contiguous(), st, lo, hi, V, 0)
    fused_decode.tp_frame(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fused_decode.tp_frame(*args)
        torch.cuda.synchronize()
    one = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type.name == "CUDA" and "tp_frame_kernel" in e.name]
    print(json.dumps(dict(
        tp_frame_launches=len(idx),
        others=sorted({e.name for e in between
                       if "tp_frame_kernel" not in e.name}),
        loop_launch_us=float(np.mean(us[:-1])) if len(us) > 1 else None,
        closing_merge_us=us[-1] if us else None,
        single_call_us=float(np.mean(one)) if one else None,
        single_calls=len(one))))
    return 0 if idx and len(one) == 20 else 1


def signed_zero_state(B, W, V, dev):
    """A beam of W live slots, each a distinct two-symbol prefix (a, b) of
    non-blank symbols (blank 0), with p_blank -0.0 and p_nonblank NEG_INF.
    Where frame 0 holds -0.0 at b, the extend (w, b) scores -0.0 + -0.0 =
    -0.0, and every candidate that adds a +-0.0 to a total scores +0.0:
    the signed-zero tie. A fresh beam never scores -0.0: logaddexp returns
    m + log1p(e) with log1p(e) >= +0.0, and -0.0 + +0.0 = +0.0."""
    import torch
    from gasr_tpu_torch.decoder import beam_search as bs
    n = V - 1
    if n * n < W:
        raise ValueError(f"V={V} has too few symbols for W={W} prefixes")
    cols = {f: [] for f in ("h1", "h2", "hp1", "hp2", "last")}
    for w in range(W):
        a, b = 1 + (w // n) % n, 1 + w % n
        hp1 = (bs.H_SEED * bs.M1 + a + 1) & bs.MASK32
        hp2 = (bs.H_SEED * bs.M2 + a + 1) & bs.MASK32
        for f, x in (("hp1", hp1), ("hp2", hp2),
                     ("h1", (hp1 * bs.M1 + b + 1) & bs.MASK32),
                     ("h2", (hp2 * bs.M2 + b + 1) & bs.MASK32), ("last", b)):
            cols[f].append(x)

    def rows(f, dtype):
        return torch.tensor(cols[f], dtype=dtype).expand(B, W).to(
            dev).contiguous()
    return bs._BeamState(
        h1=rows("h1", torch.int64), h2=rows("h2", torch.int64),
        hp1=rows("hp1", torch.int64), hp2=rows("hp2", torch.int64),
        last=rows("last", torch.int32),
        length=torch.full((B, W), 2, dtype=torch.int32, device=dev),
        tb=torch.zeros((B, W), dtype=torch.int32, device=dev),
        live=torch.ones((B, W), dtype=torch.bool, device=dev),
        s1=torch.full((B, W), -0.0, dtype=torch.float32, device=dev),
        s2=torch.full((B, W), bs.NEG_INF, dtype=torch.float32, device=dev))


def signed_zero_frame(B, V, rng):
    """Frame 0 for `signed_zero_state`: -0.0, +0.0 (30%) and -1.0 (10%),
    -0.0 at symbol 1, so slot 0's extend (0, 1) scores -0.0 at an index
    below W beside W or more +0.0 candidates."""
    z = np.where(rng.random((B, V)) < 0.3, 0.0, -0.0)
    z = np.where(rng.random((B, V)) < 0.1, -1.0, z)
    z[:, 1] = -0.0
    return z.astype(np.float32)


def queued_device_ms(fn, iters=50):
    """Mean device ms of `iters` calls of `fn`, with the launches queued
    behind a ~50 ms sleep kernel before the first event runs, so that the
    host's launch time does not pace them (a short kernel's CUDA-event
    time in a plain loop is the host's time a launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def add_ln_h_steps(h, want_x, g, b, want_h):
    """How far `add_ln`'s h lies from `add_ln_plain`'s, in bf16 steps at
    the scale of the norm's last add: the step of the largest of |h|, |b|
    and |t|, t = (x' - mu) * rsqrt(var + eps) * g in float32 (the plain
    version's expressions on its x'). Where t + b cancels, h is small and
    the last bit of mu moves it by several of its own steps, but never by
    one of t's or b's."""
    import torch
    xf = want_x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    t = (xf - mu) * torch.rsqrt(var + 1e-5) * g
    scale = torch.maximum(torch.maximum(t.abs(), b.abs().expand_as(t)),
                          want_h.float().abs())
    _, e = torch.frexp(scale)
    step = torch.ldexp(torch.ones_like(scale), e - 8)
    return (h.float() - want_h.float()).abs() / step


def cuda_events_ms(fn, iters=10, warmup=1):
    """Mean ms of `iters` calls between two CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ctc_phase(card):
    """Phase 14g, the CTC loss's kernel pair (`csrc/ctc_loss.cu`) at the
    training cell's shape: T' = 300, B = 64, V = 129, S = 97, input lengths
    275-300, label lengths 44-96, labels uniform in [1, 128], log_probs a
    log_softmax in the model's time-major layout. The loss and d loss / d
    log_probs (a random positive d loss, as the batch mean of each loss
    over its label length gives) against the plain version's on the card
    (LOSS_RTOL, GRAD_ATOL), bit-equal on a second call, two launches; then
    the pair's ms by CUDA events (the forward alone, the forward and
    backward), the host ms of a launch, beside its byte bound (log_probs
    read once, the gradient written once), the plain version's (the
    T-step loop, then with autograd's backward) and
    torch.nn.functional.ctc_loss's (forward and backward; the port never
    calls it). Returns the kernel table's entry and the launches of one
    loss and its backward."""
    import torch
    import torch.nn.functional as F
    from gasr_tpu_torch.ops.ctc_loss import ctc_loss, ctc_loss_plain
    from gasr_tpu_torch.ops.cuda import launch_counts
    dev = torch.device("cuda")
    T, B, V, S = 300, 64, 129, 97
    gen = torch.Generator(device=dev).manual_seed(21)
    lp = torch.log_softmax(2 * torch.randn((T, B, V), generator=gen,
                                           device=dev), -1)
    labels = torch.randint(1, V, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    in_len = torch.randint(275, T + 1, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    lab_len = torch.randint(44, 97, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    gloss = (torch.rand((B,), generator=gen, device=dev) + 0.5) / B

    def pair(fn):
        t = lp.detach().requires_grad_()
        loss = fn(t, labels, in_len, lab_len)
        loss.backward(gloss)
        return loss.detach(), t.grad

    before = launch_counts()
    got = pair(ctc_loss)
    torch.cuda.synchronize()
    after = launch_counts()
    runs = {k: after[k] - before[k] for k in after}
    check(runs["ctc_loss"] == 2 and sum(runs.values()) == 2,
          f"CTC loss and backward on the card: launches {runs}")
    want = pair(ctc_loss_plain)
    again = pair(ctc_loss)
    torch.cuda.synchronize()
    loss_err = float(((got[0] - want[0]) / want[0]).abs().max())
    grad_err = float((got[1] - want[1]).abs().max())
    check(loss_err <= CTC_LOSS_RTOL and grad_err <= CTC_GRAD_ATOL,
          f"CTC kernel pair against the plain version: loss {loss_err} > "
          f"{CTC_LOSS_RTOL} or grad {grad_err} > {CTC_GRAD_ATOL}")
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "CTC kernel pair: two calls differ")
    ms = cuda_events_ms(lambda: pair(ctc_loss), iters=20, warmup=2)
    fwd_ms = cuda_events_ms(lambda: ctc_loss(lp, labels, in_len, lab_len),
                            iters=20, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        ctc_loss(lp, labels, in_len, lab_len)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    plain_ms = cuda_events_ms(lambda: pair(ctc_loss_plain), iters=3)
    plain_fwd_ms = cuda_events_ms(
        lambda: ctc_loss_plain(lp, labels, in_len, lab_len), iters=3)
    args = (labels.long(), in_len.long(), lab_len.long())

    def library():
        t = lp.detach().requires_grad_()
        F.ctc_loss(t, *args, blank=0, reduction="none").backward(gloss)

    lib_ms = cuda_events_ms(library, iters=20, warmup=2)
    nbytes = 2 * T * B * V * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"ctc_loss kernel pair [T={T}, B={B}, V={V}, S={S}] on {card}: "
          f"forward + backward {ms:.4f} ms (forward {fwd_ms:.4f}, backward "
          f"{ms - fwd_ms:.4f}; host {host_ms:.4f} ms a forward call), "
          f"launches {runs['ctc_loss']}; bound {bound_ms:.4f} ms (bytes: "
          f"{nbytes / 1e6:.1f} MB); plain {plain_ms:.4f} ms (forward "
          f"{plain_fwd_ms:.4f}); F.ctc_loss {lib_ms:.4f} ms; against the "
          f"plain version: loss {loss_err:.3e} (relative), grad "
          f"{grad_err:.3e}; bit-equal on a second call", flush=True)
    return dict(ms=ms, forward_ms=fwd_ms, backward_ms=ms - fwd_ms,
                host_ms=host_ms, plain_ms=plain_ms,
                plain_forward_ms=plain_fwd_ms, library_ms=lib_ms,
                library_call="torch.nn.functional.ctc_loss",
                bound_ms=bound_ms, bound_by="bytes", max_abs_err=grad_err,
                loss_rel_err=loss_err), runs


def parakeet_phase(card):
    """Phase 16, the two kernels at `parakeet_ctc_batch`'s shapes (B = 32
    windows of 60 s, T' = 750): `flash_mhsa_rel` at H = 8, d_h = 128 (q,
    k, v strided views of the biased qkv product, as `mhsa_rel` passes
    them) against its plain version (KERNEL_REL_TOL) and its bound; and
    the one-card vocab-sharded decode that `ctc_beam_search` takes past
    the decode kernel (V = 1025, blank 1024, W = 16, lengths 688-750):
    T' + 1 `tp_frame` launches (n = 9 shards) and one traceback,
    bit-equal to the matched scan, whose eager loop is the plain version;
    ms a launch (CUDA events over `tp_frames`) against
    `asrbench/counts/fastconformer.tp_frame`'s bound, and the host ms a
    launch. Returns the kernel table's two entries."""
    import torch
    from asrbench.counts import bounds as bench_bounds
    from asrbench.counts import fastconformer as bench_counts
    from gasr_tpu_torch.decoder import beam_search as bs
    from gasr_tpu_torch.ops.cuda import flash_mhsa, fused_decode
    dev = torch.device("cuda")
    bf = torch.bfloat16
    B, H, T, dh = 32, 8, 750, 128
    D = H * dh
    gen = torch.Generator(device=dev).manual_seed(22)

    def t(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc

    qkv = t(T, B, 3 * D).to(bf)
    q, k, v = (qkv[:, :, i * D:(i + 1) * D].reshape(T, B, H, dh)
               .permute(1, 2, 0, 3) for i in range(3))
    ins = (q, k, v, t(D, D, sc=D ** -0.5), t(H, dh, sc=0.1),
           t(H, dh, sc=0.1), torch.full((B,), T, dtype=torch.int32,
                                        device=dev))
    n0 = flash_mhsa.launches
    got = flash_mhsa.flash_mhsa_rel(*ins)
    want = flash_mhsa.flash_mhsa_rel_plain(*ins)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = KERNEL_REL_TOL * max(1.0, float(want.float().abs().max()))
    check(flash_mhsa.launches == n0 + 1 and err <= tol,
          f"flash_mhsa_rel [{B}, {H}, {T}, {dh}]: {err} > {tol}")
    del got, want
    f_least, f_by = bench_bounds.flash_mhsa_rel(B, H, T, dh)
    flash = dict(ms=cuda_events_ms(lambda: flash_mhsa.flash_mhsa_rel(*ins),
                                   iters=20, warmup=2),
                 plain_ms=cuda_events_ms(
                     lambda: flash_mhsa.flash_mhsa_rel_plain(*ins), iters=2),
                 library_ms=None, max_abs_err=err, bound_ms=f_least * 1e3,
                 bound_by=f_by, shape=[B, H, T, dh])
    print(f"flash_mhsa_rel [{B}, {H}, {T}, {dh}] on {card}: "
          f"{flash['ms']:.4f} ms a launch (q, k, v views); bound "
          f"{flash['bound_ms']:.4f} ms ({f_by}), "
          f"{100 * flash['bound_ms'] / flash['ms']:.1f}% of it; plain "
          f"{flash['plain_ms']:.4f} ms; max |kernel - plain| {err} "
          f"(tolerance {tol})", flush=True)
    del ins, qkv, q, k, v

    V, W, blank = 1025, 16, 1024
    n = -(-V // fused_decode.TP_MAX_WINDOW)
    lp = torch.log_softmax(3 * t(T, B, V), -1)
    lens = torch.randint(688, T + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    before = (fused_decode.tp_frame_launches, fused_decode.decode_launches,
              fused_decode.traceback_launches)
    got = bs.ctc_beam_search(lp, W, blank_id=blank, input_lengths=lens)
    torch.cuda.synchronize()
    runs = (fused_decode.tp_frame_launches - before[0],
            fused_decode.decode_launches - before[1],
            fused_decode.traceback_launches - before[2])
    check(runs == (T + 1, 0, 1), f"ctc_beam_search at V={V}: launches "
          f"(tp_frame, decode, traceback) {runs}, not ({T + 1}, 0, 1)")
    t0 = time.perf_counter()
    want = bs.ctc_beam_search(lp, W, blank_id=blank, input_lengths=lens,
                              merge_impl="matched")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field == "scores":
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"vocab-sharded decode at V={V}: {field} "
              f"differs from the matched scan")
    past = torch.arange(T, device=dev)[:, None] >= lens[None, :]
    certain = torch.where(torch.arange(V, device=dev) == blank, 0.0,
                          bs.NEG_INF)
    masked = torch.where(past[:, :, None], certain, lp)
    init = fused_decode.pack_state(bs._init_beam(B, W, dev))
    devices = [dev] * n
    scan_ms = cuda_events_ms(lambda: fused_decode.tp_frames(
        masked, init, devices, blank), iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fused_decode.tp_frames(masked, init, devices, blank)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    whole_ms = cuda_events_ms(lambda: bs.ctc_beam_search(
        lp, W, blank_id=blank, input_lengths=lens), iters=5, warmup=1)
    least, by = bench_counts.tp_frame(B, W, V, n)
    frame = dict(ms=scan_ms / (T + 1), scan_ms=scan_ms,
                 host_ms=host_ms / (T + 1), decode_ms=whole_ms,
                 plain_ms=plain_ms, library_ms=None, max_abs_err=0.0,
                 bound_ms=least * 1e3, bound_by=by, launches=T + 1,
                 shape=dict(B=B, W=W, V=V, n=n, T=T))
    print(f"tp_frame (one card, n={n}, V={V}, W={W}, B={B}, T={T}) on "
          f"{card}: {frame['ms']:.4f} ms a launch on the device "
          f"({scan_ms:.3f} ms the {T + 1} launches), host "
          f"{frame['host_ms']:.4f} ms a launch; bound {least * 1e3:.5f} ms "
          f"a frame ({by}), {100 * least * 1e3 * T / scan_ms:.2f}% of it; "
          f"ctc_beam_search with its traceback {whole_ms:.3f} ms; the "
          f"matched scan (plain) {plain_ms:.1f} ms; equal to it (tokens, "
          f"lengths, timesteps, score bits)", flush=True)
    return {"flash_mhsa_rel_parakeet": flash, "tp_frame_parakeet": frame}


def add_ln_phase(card):
    """Phase 17, the conformer block's residual add and LayerNorm
    (`csrc/add_ln.cu`) at the two batch cells' shapes: conformer_l_batch's
    19,200 x 512 rows (T' 300, B 64) and parakeet_ctc_batch's 24,000 x
    1,024 (T' 750, B 32), x the residual stream's transposed [T', B, d]
    view, in three forms (no add; a bf16 branch at s = 0.5, as after the
    FFN; a float32 one, as after the attention). Each against
    `add_ln_plain` on the card (x' bit-equal, h off on at most
    ADD_LN_H_SHARE of elements, by at most a step, `add_ln_h_steps`); its
    device ms (`queued_device_ms`) beside its byte bound (x and y read
    once, x' and h written once), the plain version's ms and the eager
    chain's it replaces (the plain version and the copy of h that the
    next linear's reshape made, since h came out in the stream's
    transposed layout), and the host ms a launch. Then each
    cell's whole bf16 forward under no_grad on the benchmark's weights
    (`asrbench/weights.py`) and shapes: `add_ln` launches (6 a block for
    conformer_l, 5 for parakeet_ctc_1.1b), ms a forward with the kernel
    and with the plain path in turns, and the log-probs' RMS and first
    frame's largest gap between the two against the cells' limits.
    Returns the kernel table's entry."""
    import torch
    from asrbench import weights as bench_weights
    from gasr_tpu_torch.config import Config
    from gasr_tpu_torch.models import conformer as tconf
    from gasr_tpu_torch.models import model_apply
    from gasr_tpu_torch.ops.cuda import add_ln as kadd
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)

    report = {}
    for name, T, B, d in (("conformer_l_batch", 300, 64, 512),
                          ("parakeet_ctc_batch", 750, 32, 1024)):
        x = (torch.randn((B, T, d), generator=gen, device=dev) * 2 + 0.5
             ).to(bf).transpose(0, 1)
        ys = {"none": None,
              "bf16_half": torch.randn((T, B, d), generator=gen,
                                       device=dev).to(bf),
              "f32": torch.randn((T, B, d), generator=gen, device=dev)}
        s_of = {"none": 1.0, "bf16_half": 0.5, "f32": 1.0}
        g = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        rows = T * B
        entry = {}
        for form, y in ys.items():
            s = s_of[form]
            got = kadd.add_ln(x, y, s, g, b)
            want = kadd.add_ln_plain(x, y, s, g, b)
            torch.cuda.synchronize()
            u = add_ln_h_steps(got[1], want[0], g, b, want[1])
            share = float((u > 0).float().mean())
            check(torch.equal(got[0].view(torch.int16),
                              want[0].contiguous().view(torch.int16))
                  and float(u.max()) <= 1 and share <= ADD_LN_H_SHARE,
                  f"add_ln {name} {form}: x' equal "
                  f"{torch.equal(got[0], want[0])}, h {float(u.max())} "
                  f"steps off at most, on a share {share}")
            ms = queued_device_ms(lambda: kadd.add_ln(x, y, s, g, b),
                                  iters=50)
            plain_ms = cuda_events_ms(
                lambda: kadd.add_ln_plain(x, y, s, g, b), iters=10,
                warmup=2)
            chain_ms = cuda_events_ms(
                lambda: kadd.add_ln_plain(x, y, s, g, b)[1].reshape(-1, d),
                iters=10, warmup=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                kadd.add_ln(x, y, s, g, b)
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            per_elem = 2 + 2 + (0 if y is None else
                                2 + y.element_size())
            nbytes = rows * d * per_elem + 2 * d * 4
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            entry[form] = dict(ms=ms, bound_ms=bound_ms, bound_by="bytes",
                               roofline=bound_ms / ms, plain_ms=plain_ms,
                               eager_chain_ms=chain_ms, host_ms=host_ms,
                               h_one_step_share=share)
            print(f"add_ln [{rows} x {d}] {form} on {card}: {ms:.4f} ms "
                  f"(host {host_ms:.4f} ms a launch); bound {bound_ms:.4f} "
                  f"ms (bytes: {nbytes / 1e6:.1f} MB, "
                  f"{100 * bound_ms / ms:.1f}%); plain {plain_ms:.4f} ms, "
                  f"the eager chain with the next linear's copy "
                  f"{chain_ms:.4f} ms; x' bit-equal, h off on {share:.2e} "
                  f"of elements, at most {float(u.max()):.3f} steps",
                  flush=True)
        report[name] = entry
        del x, ys

    # the two cells' whole forwards
    for name, cell, per_block in (("conformer_l", "conformer_l_batch", 6),
                                  ("parakeet_ctc_1.1b",
                                   "parakeet_ctc_batch", 5)):
        spec = json.loads(open(os.path.join(
            ROOT, "asrbench", "configs", f"{name}.json")).read())
        traffic = json.loads(open(os.path.join(
            ROOT, "asrbench", "traffic",
            {"conformer_l": "batch_12s_b64",
             "parakeet_ctc_1.1b": "batch_60s_b32"}[name] + ".json")).read())
        cfg = Config.from_dict(dict(spec["program"], device="cuda",
                                    batch_size=traffic["batch"],
                                    seg_len=traffic["frames"]))
        params = bench_weights.make(spec["family"], spec["model"],
                                    torch.Generator(device=dev).manual_seed(
                                        29), dev)
        xin = torch.rand((cfg.batch_size, cfg.seg_len, cfg.input_size),
                         generator=gen, device=dev)
        n_blocks = len(params["blocks"])

        def fwd():
            with torch.no_grad():
                return model_apply(cfg, params, xin,
                                   compute_dtype="bfloat16")

        def plain_fwd():
            eligible = tconf.add_ln_eligible
            tconf.add_ln_eligible = lambda *a: False
            try:
                return fwd()
            finally:
                tconf.add_ln_eligible = eligible

        before = kadd.launches
        lp = fwd()
        torch.cuda.synchronize()
        n = kadd.launches - before
        check(n == per_block * n_blocks, f"{name} forward: add_ln launches "
              f"{n}, expected {per_block} x {n_blocks}")
        before = kadd.launches
        lp_plain = plain_fwd()
        check(kadd.launches == before, f"{name} plain forward launched "
              f"add_ln")
        diff = (lp - lp_plain).float()
        rms = float(diff.pow(2).mean().sqrt())
        gap0 = float(diff[0].abs().max())
        lim = json.loads(open(os.path.join(
            ROOT, "asrbench", "limits", f"{cell}.json")).read())["limits"]
        check(rms <= lim["lp_rms"] and gap0 <= lim["lp_gap_t0"],
              f"{name}: kernel against plain forward lp_rms {rms}, "
              f"lp_gap_t0 {gap0} past {lim}")
        del lp, lp_plain, diff
        times = [cuda_events_ms(f, iters=3, warmup=1)
                 for f in (plain_fwd, fwd, fwd, plain_fwd)]
        print(f"{name} forward [B={cfg.batch_size}, T={cfg.seg_len}, bf16, "
              f"{n_blocks} blocks] on {card}: add_ln launches {n} "
              f"({per_block} a block); ms a forward, plain / kernel / "
              f"kernel / plain: {', '.join(f'{t:.3f}' for t in times)}; "
              f"kernel against plain: lp_rms {rms:.4e}, lp_gap_t0 "
              f"{gap0:.4e} (limits {lim['lp_rms']}, {lim['lp_gap_t0']})",
              flush=True)
        report[name + "_forward"] = dict(
            launches=n, ms_plain_kernel_kernel_plain=times, lp_rms=rms,
            lp_gap_t0=gap0)
        del params, xin
        torch.cuda.empty_cache()
    return report


def parakeet_main() -> int:
    """`python3 chip_smoke.py --parakeet`: phase 16 alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from gasr_tpu_torch.ops.cuda import _lib
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"kernel build: "
          f"{_lib.build_all(['flash_mhsa', 'decode_tp', 'fused_decode']):.1f}"
          f" s (flash_mhsa, decode_tp, fused_decode)", flush=True)
    print(json.dumps(parakeet_phase(card)))
    return 0


def add_ln_main() -> int:
    """`python3 chip_smoke.py --add-ln`: phase 17 alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from gasr_tpu_torch.ops.cuda import _lib
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"kernel build: {_lib.build_all(['add_ln', 'flash_mhsa']):.1f} s "
          f"(add_ln, flash_mhsa)", flush=True)
    print(json.dumps({"add_ln": add_ln_phase(card)}))
    print(f"card: {card_line()}")
    return 0


def ctc_main() -> int:
    """`python3 chip_smoke.py --ctc`: phase 14g alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from gasr_tpu_torch.ops.cuda import _lib
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"kernel build: {_lib.build_all(['ctc_loss']):.1f} s (ctc_loss)",
          flush=True)
    report, runs = ctc_phase(card)
    print(json.dumps({"ctc_loss": report, "launches": runs}))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1

    from gasr_tpu_torch import native
    from gasr_tpu_torch.config import PRESETS, Config
    from gasr_tpu_torch.data.dataset import ids_to_text
    from gasr_tpu_torch.data.features import logmel_torch
    from gasr_tpu_torch.decoder.beam_search import (_init_beam,
                                                    _quantize_lm,
                                                    ctc_beam_search,
                                                    decode_to_lists,
                                                    streaming_init,
                                                    streaming_step)
    from gasr_tpu_torch.decoder.lm import bigram_bias_from_text
    from gasr_tpu_torch.eval import evaluate_batch
    from gasr_tpu_torch.infer import Pipeline
    from gasr_tpu_torch.models import model_apply, model_init
    from gasr_tpu_torch.models.deepspeech import deepspeech_apply_streaming
    from gasr_tpu_torch.ops.attention import _rel_shift, _sinusoid_pos
    from gasr_tpu_torch.ops.conv import conv2d
    from gasr_tpu_torch.ops.cuda import (COUNTERS, _lib, exchange_probe,
                                         flash_mhsa, fused_decode, lstm_scan,
                                         rnn_scan, stem, topk)
    from gasr_tpu_torch.ops.linear import linear
    from gasr_tpu_torch.ops.lstm import _input_projection
    from gasr_tpu_torch.parallel import decode_tp, distributed, make_mesh
    from scripts.torch_decode_probe import (frame_counts, load_build,
                                            start_count_build)

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # beside the kernels: a copy of the decode kernel that counts its block
    # barriers and the filter's survivors (scripts/torch_decode_probe.py)
    count_so, count_proc = start_count_build(_lib.BUILD / "probe_dec")
    t_build = _lib.build_all()
    count_log, _ = count_proc.communicate()
    check(count_proc.returncode == 0,
          f"the counting build of fused_decode.cu failed:\n{count_log}")
    print(f"kernel build: {t_build:.1f} s ({', '.join(_lib.SIGNATURES)})",
          flush=True)
    t0 = time.perf_counter()
    native.build()
    print(f"native host library (g++): {time.perf_counter() - t0:.1f} s",
          flush=True)

    def cuda_ms(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # every kernel's launch counter: (module, attribute)
    counters = {name: (importlib.import_module(
                    f"gasr_tpu_torch.ops.cuda.{mod}"), attr)
                for name, (mod, attr) in COUNTERS.items()}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}

    def bound(nbytes, ops, peak_ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak_ops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    rng = np.random.default_rng(20261016)
    report = {}

    # ---- 1. top-k at the decode's grid: [B, W*V] = [256, 4700], k = W
    B, T, V, W, L, H = 256, 200, 47, 100, 256, 2048
    N = W * V
    x = rng.standard_normal((B, N)).astype(np.float32)
    x[0] = np.round(x[0] * 2) / 2                       # tie-heavy row
    x[1] = np.where(rng.random(N) < 0.5, 0.0, -0.0)     # +-0.0 row
    x[1, rng.integers(0, N, 10)] = 1.0
    xt = torch.from_numpy(x).to(dev)
    kv, ki = topk.topk(xt, W)
    pv, pi = topk.topk_plain(xt, W)
    torch.cuda.synchronize()
    check(torch.equal(ki, pi), "topk indices differ from the plain version")
    check(torch.equal(kv.view(torch.int32), pv.view(torch.int32)),
          "topk values differ from the plain version in their bits")
    b_ms, b_by = bound(B * N * 4 + B * W * 8, B * N, F32_FLOPS)
    report["topk"] = dict(
        ms=cuda_ms(lambda: topk.topk(xt, W)),
        plain_ms=cuda_ms(lambda: topk.topk_plain(xt, W)),
        library_ms=cuda_ms(lambda: torch.topk(xt, W, dim=1)),
        max_abs_err=float((kv - pv).abs().max()), bound_ms=b_ms,
        bound_by=b_by)
    print("topk [256, 4700] k=100: kernel == plain (indices and value bits)",
          flush=True)

    # ---- 2. fused decode and traceback at T=200, B=256, W=100, V=47
    def log_softmax_np(z):
        z = z - z.max(-1, keepdims=True)
        return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(
            np.float32)

    lp_rand = log_softmax_np(rng.standard_normal((T, B, V)))
    logits = np.round(rng.standard_normal((T, B, V)) * 2) / 2
    lp_ties = np.maximum(logits, 0.0).astype(np.float32)  # compat_final_relu
    lp_unif = np.full((T, B, V), -np.log(V), np.float32)  # every slot's ties
    # the envelope's W = 128, V = 128 corner (16,384 candidates a frame)
    lp_edge = log_softmax_np(rng.standard_normal((40, B, 128)))
    decode_err = 0.0
    tb_err = 0
    for tag, lp_np, W_ in (("random", lp_rand, W),
                           ("tie-heavy relu", lp_ties, W),
                           ("uniform", lp_unif, W),
                           ("W=128 V=128 T=40 random", lp_edge, 128)):
        lp = torch.from_numpy(lp_np).to(dev)
        init = _init_beam(B, W_, dev)
        fin_k, ys_k = fused_decode.fused_prefix_decode(lp, init)
        fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp, init)
        torch.cuda.synchronize()
        check(torch.equal(ys_k, ys_p), f"decode ys differ ({tag})")
        for name in fused_decode.FIELDS:
            a, b = getattr(fin_k, name), getattr(fin_p, name)
            if name in ("s1", "s2"):
                diff = (a.double() - b.double()).abs().max().item()
                check(diff <= DECODE_SCORE_TOL,
                      f"decode {name} differs by {diff} ({tag})")
                decode_err = max(decode_err, diff)
            else:
                check(torch.equal(a.long(), b.long()),
                      f"decode final {name} differs ({tag})")
        tk = fused_decode.traceback(ys_k, fin_k.length, L)
        tp = fused_decode.traceback_plain(ys_k, fin_k.length, L)
        torch.cuda.synchronize()
        for a, b, what in zip(tk, tp, ("tokens", "timesteps",
                                       "start_parent")):
            check(torch.equal(a, b), f"traceback {what} differ ({tag})")
            tb_err = max(tb_err, int((a - b).abs().max()))
        print(f"decode + traceback ({tag}): kernel == plain (ys, final "
              f"state, tokens, timesteps, start_parent; scores err "
              f"{decode_err})", flush=True)
        if tag == "random":
            init_r, ys_r, fin_r, lp_r = init, ys_k, fin_k, lp
            len_r = fin_k.length
    del lp_unif, lp_edge

    # the decode kernel's launch at the main paths' shapes: blocks an SM
    # (the occupancy query), registers (cudaFuncGetAttributes), the dynamic
    # shared memory a block that the launch requests
    dec_lib = _lib.load("fused_decode")
    occupancy = {}
    for tag_, (W_, V_, lm_) in {"reference_large W=100 V=47": (100, 47, 0),
                                "conformer_l W=16 V=129": (16, 129, 0),
                                "LM W=64 V=129": (64, 129, 1)}.items():
        vals = [ctypes.c_int(0) for _ in range(3)]
        _lib.check(dec_lib.fused_prefix_decode_info(
            W_, V_, lm_, *[ctypes.byref(v_) for v_ in vals]),
            "fused_prefix_decode_info")
        occupancy[tag_] = dict(zip(("blocks_per_sm", "registers",
                                    "smem_requested_bytes"),
                                   [v_.value for v_ in vals]))
    check(occupancy["reference_large W=100 V=47"]["blocks_per_sm"] >= 2,
          f"the decode kernel holds fewer than 2 blocks an SM: {occupancy}")
    print(f"decode kernel launch (blocks an SM, registers a thread, dynamic "
          f"shared bytes requested a block): {occupancy}", flush=True)
    # block barriers and survivors a frame, counted by the counting copy on
    # the random log-probs (its result must be the kernel's, bit for bit)
    count_lib = load_build(count_so)
    _lib.check(count_lib.gasr_probe_reset(), "probe reset")
    _lib._loaded["fused_decode"] = count_lib
    try:
        fin_c, ys_c = fused_decode.fused_prefix_decode(lp_r, init_r)
        torch.cuda.synchronize()
    finally:
        _lib._loaded["fused_decode"] = dec_lib
    check(torch.equal(ys_c, ys_r) and torch.equal(
        fused_decode.pack_state(fin_c), fused_decode.pack_state(fin_r)),
        "the counting copy of the decode kernel differs from the kernel")
    bars, survivors = frame_counts(count_lib, T * B)
    frame_counted = {"barriers_per_frame": bars,
                     "survivors_per_frame": survivors,
                     "candidates_per_frame": W * V}
    print(f"decode kernel, counted over one call at T={T}, B={B}, W={W}, "
          f"V={V} (the prologue's barriers included): {bars:.3f} block "
          f"barriers a frame, {survivors:.1f} of {W * V} candidates a frame "
          f"kept by the filter", flush=True)

    nb = (T * B * V * 4 + 2 * 9 * B * W * 4 + T * B * W * 4)
    b_ms, b_by = bound(nb, T * B * (2 * W * V + 30 * W), F32_FLOPS)
    report["fused_prefix_decode"] = dict(
        ms=cuda_ms(lambda: fused_decode.fused_prefix_decode(lp_r, init_r),
                   iters=5, warmup=1),
        plain_ms=cuda_ms(
            lambda: fused_decode.fused_prefix_decode_plain(lp_r, init_r),
            iters=1, warmup=1),
        library_ms=None, max_abs_err=decode_err, bound_ms=b_ms,
        bound_by=b_by, occupancy=occupancy, frame_counted=frame_counted)
    nb = T * B * W * 4 + 2 * B * W * 4 + 2 * B * W * L * 4
    b_ms, b_by = bound(nb, T * B * W * 5, F32_FLOPS)
    report["traceback"] = dict(
        ms=cuda_ms(lambda: fused_decode.traceback(ys_r, len_r, L)),
        plain_ms=cuda_ms(lambda: fused_decode.traceback_plain(ys_r, len_r, L),
                         iters=2, warmup=1),
        library_ms=None, max_abs_err=float(tb_err), bound_ms=b_ms,
        bound_by=b_by)

    # ---- 2b. topk_impl="approx" at the same shape, through the decoder.
    # JAX's approx_max_k takes lax.top_k's top-W at k < n off the TPU
    # (tests/test_torch_decode.py), so the decode kernel runs it: one
    # fused_prefix_decode and one traceback launch, no standalone topk
    rng_a = np.random.default_rng(20261017)
    lm_a = torch.from_numpy((rng_a.standard_normal((V + 1, V)) * 2).astype(
        np.float32)).to(dev)
    res_e = ctc_beam_search(lp_r, beam_width=W, max_len=L)
    approx_runs = {}
    for tag, kw in (("no LM", {}), ("LM", {"lm_bias": lm_a})):
        ctc_beam_search(lp_r, beam_width=W, max_len=L, topk_impl="approx",
                        **kw)                                 # warm-up
        torch.cuda.synchronize()
        zero_counts()
        res_a = ctc_beam_search(lp_r, beam_width=W, max_len=L,
                                topk_impl="approx", **kw)
        torch.cuda.synchronize()
        got = read_counts()
        want = {name: 0 for name in got}
        want.update(fused_prefix_decode=1, traceback=1,
                    fused_prefix_decode_lm=int(tag == "LM"))
        check(got == want, f"approx decode ({tag}) launched {got}")
        approx_runs[tag] = got
        res_ap = ctc_beam_search(lp_r, beam_width=W, max_len=L,
                                 topk_impl="approx", merge_impl="matched",
                                 **kw)
        for field in ("tokens", "lengths", "timesteps", "overflow"):
            check(torch.equal(getattr(res_a, field), getattr(res_ap, field)),
                  f"approx decode ({tag}): kernel and plain {field} differ")
        check(torch.equal(res_a.scores.view(torch.int32),
                          res_ap.scores.view(torch.int32)),
              f"approx decode ({tag}): kernel and plain score bits differ")
        if tag == "no LM":
            res_a0 = res_a
    print(f"approx decode (ctc_beam_search topk_impl='approx', T={T}, B={B}, "
          f"W={W}, V={V}), with and without an LM: launches "
          f"{approx_runs['no LM']} / {approx_runs['LM']}; kernel == plain "
          f"(tokens, lengths, timesteps, overflow, score bits)", flush=True)
    # recall of the approx decode's final beams against the exact kernel
    # decode's: the share of the exact (b, w) hypotheses (live prefixes)
    # that the approx beams hold too
    tok_a, tok_e = res_a0.tokens.cpu().numpy(), res_e.tokens.cpu().numpy()
    len_a, len_e = (res_a0.lengths.cpu().numpy(),
                    res_e.lengths.cpu().numpy())
    live_e = (res_e.scores > -1e29).cpu().numpy()
    live_a = (res_a0.scores > -1e29).cpu().numpy()
    found = total = 0
    for b in range(B):
        hyp_a = {tuple(tok_a[b, w, :len_a[b, w]]) for w in range(W)
                 if live_a[b, w]}
        for w in range(W):
            if live_e[b, w]:
                total += 1
                found += tuple(tok_e[b, w, :len_e[b, w]]) in hyp_a
    recall = found / total
    check(recall == 1.0, f"approx decode recall {recall} against exact")
    # the signed-zero tie inside the kernel: a hand-made beam whose live
    # slots carry p_blank -0.0, frame 0 of -0.0, +0.0 and -1.0 (-0.0 at
    # symbol 1), the rest phase 2's log-probs; fused_prefix_decode takes the
    # packed state. Where +0.0 and -0.0 tie, lax.top_k and lax.approx_max_k
    # (at k < n) both rank +0.0 first, so the two orders cannot differ on
    # this or any state: the check is the kernel against its plain version
    zinit = signed_zero_state(B, W, V, dev)
    lp_z = lp_r.clone()
    lp_z[0] = torch.from_numpy(signed_zero_frame(B, V, rng_a)).to(dev)
    zero_counts()
    fin_zk, ys_zk = fused_decode.fused_prefix_decode(lp_z, zinit)
    torch.cuda.synchronize()
    check(read_counts()["fused_prefix_decode"] == 1,
          "the signed-zero decode did not launch the kernel")
    fin_zp, ys_zp = fused_decode.fused_prefix_decode_plain(lp_z, zinit)
    check(torch.equal(ys_zk, ys_zp) and torch.equal(
        fused_decode.pack_state(fin_zk), fused_decode.pack_state(fin_zp)),
        "signed-zero decode: kernel and plain differ")
    zc = ys_zk[0].long()
    check(not bool((((zc & 0x7FFF) == 0) & (((zc >> 15) & 0x7FFF) == 1)
                    & (((zc >> 30) & 1) == 1)).any()),
          "signed-zero decode: the -0.0 extend (slot 0, symbol 1) won "
          "frame 0 over +0.0 candidates")
    # ms: whole decodes (decode + traceback) both ways, in turns
    turns = {"exact": [], "approx": []}
    for impl in ("exact", "approx", "approx", "exact"):
        turns[impl].append(cuda_ms(lambda impl=impl: ctc_beam_search(
            lp_r, beam_width=W, max_len=L, topk_impl=impl), iters=5,
            warmup=1))
    approx_ms = min(turns["approx"])
    exact_ms = min(turns["exact"])
    print(f"approx decode: recall of the final beams against the exact "
          f"kernel decode {recall} ({found} of {total} live hypotheses; "
          f"JAX's recall_target 0.99); signed-zero init: kernel == plain "
          f"(ys, final state), +0.0 ranked above -0.0 as lax.top_k and "
          f"lax.approx_max_k rank them; ctc_beam_search ms (decode + "
          f"traceback, CUDA events, best of 2 turns of 5): approx "
          f"{approx_ms:.4f}, exact {exact_ms:.4f} on {card_line()}",
          flush=True)
    report["fused_prefix_decode"]["approx"] = dict(
        launches=approx_runs["no LM"]["fused_prefix_decode"],
        launches_lm=approx_runs["LM"]["fused_prefix_decode"],
        ms=approx_ms, exact_ms=exact_ms, max_abs_err=0.0, recall=recall,
        recall_target=0.99, signed_zero_state="kernel == plain")
    del res_e, res_a, res_ap, res_a0, lp_z

    # ---- 3. recurrence at T=200, B=256, H=2048, over RNN_SEEDS
    bnd = 1.0 / H ** 0.5
    h0 = torch.zeros(B, H, device=dev)
    step_err = rnn_err = rev_err = 0.0
    for seed in RNN_SEEDS:
        r_rng = np.random.default_rng(seed)
        xw = torch.from_numpy((r_rng.standard_normal((T, B, H)) * 0.5
                               ).astype(np.float32)).to(dev)
        w_hh = torch.from_numpy(
            r_rng.uniform(-bnd, bnd, (H, H)).astype(np.float32)).to(dev)
        h_rand = torch.tanh(torch.from_numpy(
            r_rng.standard_normal((B, H)).astype(np.float32)).to(dev))
        s_err = float((rnn_scan.rnn_scan(xw[:1], w_hh, h_rand)
                       - rnn_scan.rnn_scan_plain(xw[:1], w_hh, h_rand)
                       ).abs().max())
        check(s_err <= RNN_STEP_TOL, f"rnn_scan step differs by {s_err} "
              f"(seed {seed})")
        rk = rnn_scan.rnn_scan(xw, w_hh, h0)
        rp = rnn_scan.rnn_scan_plain(xw, w_hh, h0)
        check(bool(torch.isfinite(rk).all()), "rnn_scan output not finite")
        s_scan = float((rk - rp).abs().max())
        s_mean = float((rk - rp).abs().mean())
        check(s_scan <= RNN_SCAN_TOL,
              f"rnn_scan differs from plain by {s_scan} (seed {seed})")
        s_rev = float((rnn_scan.rnn_scan(xw[:8], w_hh, h_rand, reverse=True)
                       - rnn_scan.rnn_scan_plain(xw[:8], w_hh, h_rand,
                                                 reverse=True)).abs().max())
        check(s_rev <= RNN_SCAN_TOL,
              f"reverse rnn_scan differs by {s_rev} (seed {seed})")
        print(f"rnn_scan B=256 H=2048 seed {seed}: one step max |kernel - "
              f"plain| = {s_err} (tolerance {RNN_STEP_TOL}); T=200 max "
              f"{s_scan}, mean {s_mean} (tolerance {RNN_SCAN_TOL}); reverse, "
              f"8 steps: max {s_rev}", flush=True)
        step_err, rnn_err = max(step_err, s_err), max(rnn_err, s_scan)
        rev_err = max(rev_err, s_rev)
    w_bf = w_hh.to(torch.bfloat16)

    def library_rnn():
        h = h0.to(torch.bfloat16)
        for t in range(T):
            h = torch.tanh(xw[t] + torch.matmul(h, w_bf)).to(torch.bfloat16)

    # the kernel and its library yardstick in turns, 5 rounds of one call
    # each after a warm-up; medians
    def run_kernel():
        rnn_scan.rnn_scan(xw, w_hh, h0)

    rounds = {"kernel": [], "library": []}
    for _ in range(5):
        rounds["kernel"].append(cuda_ms(run_kernel, iters=1, warmup=1))
        rounds["library"].append(cuda_ms(library_rnn, iters=1, warmup=1))
    n0 = rnn_scan.launches
    run_kernel()
    per_call = rnn_scan.launches - n0
    check(per_call == 1, f"rnn_scan launched {per_call} kernels a call")
    b_ms, b_by = bound(2 * T * B * H * 4 + H * H * 2 + B * H * 4,
                       2 * T * B * H * H, BF16_TENSOR_FLOPS)
    report["rnn_scan"] = dict(
        ms=float(np.median(rounds["kernel"])),
        plain_ms=cuda_ms(lambda: rnn_scan.rnn_scan_plain(xw, w_hh, h0),
                         iters=3, warmup=1),
        library_ms=float(np.median(rounds["library"])),
        ms_rounds=rounds["kernel"], library_ms_rounds=rounds["library"],
        kernel_launches_per_call=per_call,
        max_abs_err=max(step_err, rnn_err, rev_err), bound_ms=b_ms,
        bound_by=b_by)
    print(f"rnn_scan T={T} B={B} H={H} on {card}: kernel "
          f"{report['rnn_scan']['ms']:.4f} ms, bf16 matmul + tanh loop "
          f"{report['rnn_scan']['library_ms']:.4f} ms (medians of 5 rounds "
          f"in turns: kernel {[round(x, 4) for x in rounds['kernel']]}, "
          f"loop {[round(x, 4) for x in rounds['library']]}); 1 launch a "
          f"call", flush=True)

    # ---- 4. golden fixtures through the port on the card: the prefix
    # ones through the kernels, reference_small through the sort merge
    for name, kw in (("prefix_small", {}), ("prefix_wide", {}),
                     ("prefix_lens", {"input_lengths": torch.tensor(
                         [18, 12, 7], device=dev)}),
                     ("reference_small", {"algorithm": "reference"})):
        d = np.load(os.path.join(ROOT, "tests", "golden", name + ".npz"))
        res = ctc_beam_search(torch.from_numpy(d["log_probs"]).to(dev),
                              beam_width=d["tokens"].shape[1], max_len=32,
                              **kw)
        for field in ("tokens", "lengths", "timesteps"):
            check(np.array_equal(getattr(res, field).cpu().numpy(),
                                 d[field]), f"golden {name}: {field}")
        err = float(np.abs(res.scores.cpu().numpy() - d["scores"]).max())
        check(err <= GOLDEN_SCORE_TOL, f"golden {name}: scores err {err}")
        print(f"golden {name}: tokens, lengths, timesteps equal; scores err "
              f"{err}", flush=True)

    # ---- 5. small forward + decode: card against the CPU, over FWD_SEEDS
    # B=8: the recurrence kernel's shape rule (H % 128 == 0, B % 8 == 0)
    small = Config(batch_size=8, seg_len=20, linear_size=256,
                   rnn_hidden_size=256, beam_width=16, device="cpu")
    for seed in FWD_SEEDS:
        feats_small = np.random.default_rng(seed).uniform(
            size=(8, 20, small.feat_size)).astype(np.float32)
        errs = {}
        for impl in ("scan", "pallas"):
            c = dataclasses.replace(small, rnn_impl=impl)
            # the same seed gives the same weights on both devices
            lp_cpu = Pipeline(c, generator=torch.Generator().manual_seed(
                seed)).log_probs(feats_small)
            lp_gpu = Pipeline(dataclasses.replace(c, device="cuda"),
                              generator=torch.Generator().manual_seed(seed)
                              ).log_probs(feats_small)
            errs[impl] = float((lp_gpu.cpu() - lp_cpu).abs().max())
            check(errs[impl] <= FWD_CARD_CPU_TOL[impl],
                  f"small forward card vs CPU, rnn_impl={impl}, seed "
                  f"{seed}: {errs[impl]}")
            # forward + decode on the CPU against forward + decode on the card
            r_cpu = decode_to_lists(ctc_beam_search(lp_cpu, beam_width=16))
            r_gpu = decode_to_lists(ctc_beam_search(lp_gpu, beam_width=16))
            check([ids for ids, _ in r_cpu] == [ids for ids, _ in r_gpu],
                  f"small transcripts card vs CPU differ, rnn_impl={impl}, "
                  f"seed {seed}")
        print(f"small forward card vs CPU, seed {seed}: max err rnn_impl="
              f"scan {errs['scan']} (tolerance {FWD_CARD_CPU_TOL['scan']}), "
              f"pallas {errs['pallas']} (tolerance "
              f"{FWD_CARD_CPU_TOL['pallas']}); transcripts of forward + "
              f"decode equal, card vs CPU, both rnn_impl", flush=True)

    # ---- 6. the main path: Pipeline.transcribe on reference_large
    cfg = dataclasses.replace(PRESETS["reference_large"], rnn_impl="pallas")
    params = model_init(cfg, torch.Generator().manual_seed(0))
    pipe = Pipeline(cfg, params=params)
    feats = rng.uniform(size=(cfg.batch_size, cfg.seg_len,
                              cfg.feat_size)).astype(np.float32)
    x = torch.from_numpy(feats).to(dev)
    pipe.transcribe(x)                                   # warm-up
    torch.cuda.synchronize()

    zero_counts()
    out = pipe.transcribe(x)
    torch.cuda.synchronize()
    launches = read_counts()
    # The main path runs topk.cuh's filtered top-W as device functions
    # inside each fused_prefix_decode launch, never the standalone topk
    # kernel (the same functions in a launch of their own); what shows it
    # ran is the decode kernel's launch and its bit-equality with the plain
    # decoder (which sorts on the same keys).
    inside = {"topk": "fused_prefix_decode"}
    for name in ("fused_prefix_decode", "traceback", "rnn_scan"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    # one persistent launch for the one recurrent layer
    check(launches["rnn_scan"] == cfg.rnn_num_layers,
          f"transcribe launched rnn_scan {launches['rnn_scan']} times")
    for name in ("traceback_overlay", "flash_mhsa_rel", "fused_stem",
                 "lstm_scan"):
        check(launches[name] == 0, f"transcribe launched {name}")
    print(f"main path launches per transcribe: {launches} (topk runs inside "
          f"fused_prefix_decode)", flush=True)

    lp = pipe.log_probs(x)
    check(tuple(lp.shape) == (cfg.seg_len, cfg.batch_size, cfg.output_size),
          f"log_probs shape {tuple(lp.shape)}")
    check(bool(torch.isfinite(lp).all()), "log_probs not finite")
    check(float((lp.exp().sum(-1) - 1).abs().max()) < 1e-4,
          "log_probs rows do not normalise")
    res_k = ctc_beam_search(lp, beam_width=cfg.beam_width,
                            max_len=cfg.decode_max_len)
    res_p = ctc_beam_search(lp, beam_width=cfg.beam_width,
                            max_len=cfg.decode_max_len, merge_impl="matched")
    for field in ("tokens", "lengths", "timesteps"):
        check(torch.equal(getattr(res_k, field), getattr(res_p, field)),
              f"main path decode: kernel and plain {field} differ")
    tr_k = decode_to_lists(res_k)
    check([ids for ids, _ in tr_k] == [ids for ids, _ in
                                      decode_to_lists(res_p)],
          "main path transcripts differ between kernel and plain decode")
    check([ids for ids, _ in out] == [ids for ids, _ in tr_k],
          "transcribe differs from its own stages")

    def host_ms(fn, iters=5):
        """Median host-clock ms of whole calls, synchronised around each."""
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[iters // 2]

    # end to end: whole transcribe calls; the stages beside it as breakdown
    e2e_ms = host_ms(lambda: pipe.transcribe(x))
    fwd_ms = cuda_ms(lambda: pipe.log_probs(x), iters=3, warmup=1)
    dec_ms = host_ms(lambda: decode_to_lists(ctc_beam_search(
        lp, beam_width=cfg.beam_width, max_len=cfg.decode_max_len)))
    audio_s = cfg.batch_size * cfg.seg_len * 0.01
    rate = audio_s / (e2e_ms / 1e3)
    mean_len = float(np.mean([len(ids) for ids, _ in out]))
    print(f"transcribe reference_large (B=256, T=200, rnn_impl=pallas) on "
          f"{card}: transcribe {e2e_ms:.3f} ms (median of 5 whole calls, "
          f"host clock) = {rate:.1f} audio-seconds/s; breakdown: forward "
          f"{fwd_ms:.3f} ms (CUDA events, mean of 3), decode {dec_ms:.3f} "
          f"ms (median of 5, host clock incl. D2H and lists); mean "
          f"transcript length {mean_len:.1f}", flush=True)

    # ---- 7. the streaming path: the same log-probs in chunks of 20 frames
    n_chunks = cfg.seg_len // STREAM_TC
    W, L = cfg.beam_width, cfg.decode_max_len

    def stream(lp_in, keep=False):
        st = streaming_init(cfg.batch_size, W, max_len=L, device=dev)
        states, snap = [st], None
        for i in range(n_chunks):
            st, snap = streaming_step(
                st, lp_in[i * STREAM_TC:(i + 1) * STREAM_TC])
            if keep:
                states.append(st)
        return states, snap

    stream(lp)                                           # warm-up
    torch.cuda.synchronize()
    zero_counts()
    states, snap = stream(lp, keep=True)
    torch.cuda.synchronize()
    s_launches = read_counts()
    want_launches = {"fused_prefix_decode": n_chunks,
                     "traceback_overlay": n_chunks, "traceback": 0}
    for name, n in want_launches.items():
        check(s_launches[name] == n, f"streaming launches of {name}: "
              f"{s_launches[name]}, expected {n}")
    print(f"streaming path launches per stream of {n_chunks} chunks: "
          f"{s_launches}", flush=True)
    for field in ("tokens", "lengths", "timesteps", "overflow"):
        check(torch.equal(getattr(snap, field), getattr(res_k, field)),
              f"streaming decode {field} differ from the batch decode")
    check(torch.equal(snap.scores.view(torch.int32),
                      res_k.scores.view(torch.int32)),
          "streaming decode scores differ from the batch decode in their "
          "bits")
    print(f"streaming decode ({n_chunks} x {STREAM_TC} frames) == batch "
          f"decode: tokens, lengths, timesteps, overflow equal, scores "
          f"bit-equal", flush=True)

    # each checked chunk's overlay output (made by the kernel in the
    # counted run) against the plain version on the same inputs
    ov_err = 0
    for i in (0, n_chunks // 2, n_chunks - 1):
        st0, st1 = states[i], states[i + 1]
        chunk = lp[i * STREAM_TC:(i + 1) * STREAM_TC]
        fin_i, ys_i = fused_decode.fused_prefix_decode(chunk, st0.beam)
        check(torch.equal(fin_i.length, st1.beam.length),
              f"chunk {i}: decode rerun differs")
        want = fused_decode.traceback_overlay_plain(
            ys_i, fin_i.length, st0.tokens, st0.timesteps, st0.frames)
        for a, b, what in zip((st1.tokens, st1.timesteps), want,
                              ("tokens", "timesteps")):
            check(torch.equal(a, b), f"traceback_overlay {what} differ "
                  f"from the plain version on chunk {i}")
            ov_err = max(ov_err, int((a - b).abs().max()))
        if i == n_chunks // 2:
            ov_args = (ys_i, fin_i.length, st0.tokens, st0.timesteps,
                       st0.frames)
    print(f"traceback_overlay == plain on chunks 0, {n_chunks // 2}, "
          f"{n_chunks - 1} (tokens, timesteps)", flush=True)
    del states
    nb = (STREAM_TC * B * W * 4 + 2 * B * W * 4 + 4 * B * W * L * 4)
    b_ms, b_by = bound(nb, STREAM_TC * B * W * 5, F32_FLOPS)
    report["traceback_overlay"] = dict(
        ms=cuda_ms(lambda: fused_decode.traceback_overlay(*ov_args),
                   iters=20, warmup=3),
        plain_ms=cuda_ms(
            lambda: fused_decode.traceback_overlay_plain(*ov_args),
            iters=2, warmup=1),
        library_ms=None, max_abs_err=float(ov_err), bound_ms=b_ms,
        bound_by=b_by)

    def step_ms_mean():
        st = streaming_init(cfg.batch_size, W, max_len=L, device=dev)
        times = []
        for i in range(n_chunks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = streaming_step(
                st, lp[i * STREAM_TC:(i + 1) * STREAM_TC])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.mean(times))

    stream_ms = host_ms(lambda: stream(lp))
    step_ms = sorted(step_ms_mean() for _ in range(5))[2]
    batch_ms = host_ms(lambda: ctc_beam_search(
        lp, beam_width=W, max_len=L))
    print(f"streaming decode reference_large ({n_chunks} chunks of "
          f"{STREAM_TC} frames) on {card}: whole stream {stream_ms:.3f} ms "
          f"(median of 5, host clock), per streaming_step {step_ms:.3f} ms "
          f"(mean of {n_chunks}, median of 5 streams), batch decode "
          f"{batch_ms:.3f} ms (median of 5), streaming / batch "
          f"{stream_ms / batch_ms:.3f}", flush=True)

    # Pipeline.transcribe_streaming: chunked float32 forward with carried
    # RNN state, against the one-shot float32 forward (rnn_impl="scan")
    pipe_s = Pipeline(dataclasses.replace(cfg, rnn_impl="scan"),
                      params=params)
    chunks = [x[:, i * STREAM_TC:(i + 1) * STREAM_TC]
              for i in range(n_chunks)]
    with torch.no_grad():
        lp_parts, rnn_state = [], None
        for c in chunks:
            part, rnn_state = deepspeech_apply_streaming(params, c,
                                                         rnn_state)
            lp_parts.append(part)
    lp_one = pipe_s.log_probs(x)
    lp_err = float((torch.cat(lp_parts) - lp_one).abs().max())
    check(lp_err <= STREAM_LP_TOL, f"chunked forward differs from the "
          f"one-shot forward by {lp_err}")
    # the launches of one whole call each: the float32 forward launches
    # none of the port's kernels (rnn_impl="scan"); the batch call one
    # decode and one traceback, the stream a decode and an overlay a chunk
    pipe_s.transcribe_streaming(chunks)                 # warm-up
    torch.cuda.synchronize()
    zero_counts()
    out_s = pipe_s.transcribe_streaming(chunks)
    torch.cuda.synchronize()
    ts_launches = read_counts()
    zero_counts()
    out_one = pipe_s.transcribe(x)
    torch.cuda.synchronize()
    scan_launches = read_counts()
    for what, got_, want_ in (
            ("transcribe_streaming", ts_launches,
             {"fused_prefix_decode": n_chunks, "traceback_overlay": n_chunks}),
            ("transcribe", scan_launches,
             {"fused_prefix_decode": 1, "traceback": 1})):
        check(all(got_[k] == v for k, v in want_.items())
              and sum(got_.values()) == sum(want_.values()),
              f"{what} with rnn_impl='scan': launches {got_}, expected "
              f"{want_}")
    n_same = sum(a[0] == b[0] for a, b in zip(out_s, out_one))
    ts_ms = host_ms(lambda: pipe_s.transcribe_streaming(chunks))
    print(f"transcribe_streaming reference_large (float32 forward, "
          f"{n_chunks} chunks of {STREAM_TC} frames) on {card}: "
          f"{ts_ms:.3f} ms (median of 5 whole calls, host clock) = "
          f"{audio_s / (ts_ms / 1e3):.1f} audio-seconds/s; log-probs max "
          f"|chunked - one-shot| {lp_err} (tolerance {STREAM_LP_TOL}); "
          f"transcripts equal to the one-shot transcribe: {n_same} of "
          f"{len(out_one)}; launches of one call {ts_launches}, of the "
          f"one-shot transcribe {scan_launches}", flush=True)

    # ---- 8. the conformer path: conformer_l at full width on one card
    F8 = torch.nn.functional
    bf = torch.bfloat16

    def masked_err(got, want, lens):
        """max |got - want| and max |want| over the valid query rows."""
        T_ = got.shape[2]
        rows = (torch.arange(T_, device=dev)[None, :]
                < lens[:, None])[:, None, :, None]
        g, w = got.float(), want.float()
        return (float(torch.where(rows, (g - w).abs(), 0.0).max()),
                float(torch.where(rows, w.abs(), 0.0).max()))

    def flash_inputs(B_, H_, T_, dh_, seed, ragged, views=False):
        """views=True: q, k, v as mhsa_rel passes them, permuted bf16 views
        of one [T, B, 3D] qkv product; ragged="zero" also sets one length
        to 0."""
        f_rng = np.random.default_rng(seed)

        def t(*shape, sc=1.0):
            return torch.from_numpy((f_rng.standard_normal(shape) * sc
                                     ).astype(np.float32)).to(dev)
        D_ = H_ * dh_
        lens = f_rng.integers(1, T_ + 1, B_) if ragged else np.full(B_, T_)
        if ragged == "zero":
            lens[B_ // 2] = 0
        if views:
            qkv = t(T_, B_, 3 * D_).to(bf)
            qkv_v = [qkv[:, :, i * D_:(i + 1) * D_].reshape(T_, B_, H_, dh_)
                     .permute(1, 2, 0, 3) for i in range(3)]
        else:
            qkv_v = [t(B_, H_, T_, dh_).to(bf) for _ in range(3)]
        return (*qkv_v, t(D_, D_, sc=D_ ** -0.5), t(H_, dh_, sc=0.1),
                t(H_, dh_, sc=0.1),
                torch.from_numpy(lens.astype(np.int32)).to(dev))

    # 8a. flash attention kernel against its plain version: conformer_l's
    # shape full, ragged, ragged with a length of 0 and as mhsa_rel passes
    # q, k, v (strided views of the qkv product), conformer_s's (dh = 36)
    # contiguous and as views, T = 1024 at D = 512 and D = 4096, T = 2
    flash_err = 0.0
    fl_ins = {}                 # conformer_l's full batch: views, contiguous
    for B_, H_, T_, dh_, ragged, views in (
            (64, 8, 300, 64, False, False), (64, 8, 300, 64, False, True),
            (64, 8, 300, 64, True, False), (64, 8, 300, 64, "zero", True),
            (32, 4, 150, 36, True, False), (32, 4, 150, 36, True, True),
            (4, 8, 1024, 64, True, False), (1, 32, 1024, 128, True, False),
            (8, 8, 2, 64, False, False)):
        ins = flash_inputs(B_, H_, T_, dh_, T_ + dh_ + bool(ragged), ragged,
                           views)
        what = (f"flash_mhsa_rel [{B_}, {H_}, {T_}, {dh_}] ragged={ragged} "
                f"views={views}")
        for out_f32 in (False, True):
            got = flash_mhsa.flash_mhsa_rel(*ins, out_f32=out_f32)
            want = flash_mhsa.flash_mhsa_rel_plain(*ins, out_f32=out_f32)
            torch.cuda.synchronize()
            # valid query rows; a length of 0 averages v on every row
            err, scale = masked_err(got, want, torch.where(
                ins[-1] > 0, ins[-1], T_))
            tol = KERNEL_REL_TOL * max(1.0, scale)
            check(got.dtype == want.dtype and bool(torch.isfinite(got).all()),
                  f"{what} output")
            check(err <= tol, f"{what} out_f32={out_f32}: {err} > {tol}")
            flash_err = max(flash_err, err)
            print(f"{what} out_f32={out_f32}: max |kernel - plain| {err} "
                  f"(tolerance {tol}, max |plain| {scale})", flush=True)
        if (T_, ragged) == (300, False):
            fl_ins[views] = ins
        del ins, got, want
    # time at conformer_l's shape, as mhsa_rel calls it (q, k, v strided
    # views) and on contiguous inputs; the yardstick is SDPA with the
    # position term precomputed as a [B, H, T, T] additive bf16 mask (SDPA
    # takes a float mask only in the query's dtype), not timed
    fl_views, fl_cont = fl_ins[True], fl_ins[False]
    q8, k8, v8, wr8, u8, vb8, len8 = fl_cont
    B_, H_, T_, dh_ = q8.shape
    D_ = H_ * dh_
    with torch.no_grad():
        r8 = (_sinusoid_pos(T_, D_, dev) @ wr8).reshape(2 * T_ - 1, H_, dh_)
        bd8 = _rel_shift(torch.einsum("bhtd,lhd->bhtl",
                                      q8.float() + vb8[None, :, None], r8))
        mask8 = (bd8 / dh_ ** 0.5).to(bf)
        qu8 = (q8.float() + u8[None, :, None]).to(bf)
    del r8, bd8
    # the work the function needs: qu.k, qv.R at every (t, s) and p.v,
    # and the R product; q, k, v and the output at bf16, wr at float32
    fl_flops = 2 * B_ * H_ * 3 * T_ * T_ * dh_ + 2 * (2 * T_ - 1) * D_ * D_
    fl_bytes = 4 * q8.numel() * 2 + wr8.numel() * 4 + 2 * u8.numel() * 4
    b_ms, b_by = bound(fl_bytes, fl_flops, BF16_TENSOR_FLOPS)
    # the count of the factorized form (the kernel's earlier design)
    old_ms, old_by = bound(fl_bytes, 2 * B_ * H_ * (
        2 * T_ * T_ * dh_ + T_ * dh_ * D_ + T_ * T_ * D_), BF16_TENSOR_FLOPS)
    fl_ms_cont = cuda_ms(lambda: flash_mhsa.flash_mhsa_rel(*fl_cont))
    report["flash_mhsa_rel"] = dict(
        ms=cuda_ms(lambda: flash_mhsa.flash_mhsa_rel(*fl_views)),
        ms_contiguous=fl_ms_cont,
        plain_ms=cuda_ms(lambda: flash_mhsa.flash_mhsa_rel_plain(*fl_cont),
                         iters=3, warmup=1),
        library_ms=cuda_ms(lambda: F8.scaled_dot_product_attention(
            qu8, k8, v8, attn_mask=mask8)),
        library_call="scaled_dot_product_attention(q+u, k, v, attn_mask="
                     "bd/sqrt(dh) precomputed [B,H,T,T] bf16)",
        max_abs_err=flash_err, bound_ms=b_ms, bound_by=b_by)
    r = report["flash_mhsa_rel"]
    print(f"flash_mhsa_rel [{B_}, {H_}, {T_}, {dh_}] on {card}: "
          f"{r['ms']:.4f} ms as mhsa_rel calls it (q, k, v views), "
          f"{fl_ms_cont:.4f} ms on contiguous inputs; bound {b_ms:.4f} ms "
          f"({b_by}: {fl_bytes / 1e6:.1f} MB, {fl_flops / 1e9:.2f} GFLOP; "
          f"the factorized form's count {old_ms:.4f} ms, {old_by}); SDPA "
          f"{r['library_ms']:.4f} ms", flush=True)
    del qu8, mask8, fl_ins, fl_views, fl_cont

    # 8b. the fused stem against its plain version on conformer_l's
    # weights: T = 1200 -> T/4 = 300, T = 1000 (T/4 = 250: the last row
    # tile of a b holds 8 of 128 rows), x as a strided view (its
    # transpose's transpose, read through its strides), a batch of 0; and
    # on random weights F/4 = 3 (d = 512), T = F = 8 (d = dout = 128)
    cfg_c = dataclasses.replace(PRESETS["conformer_l"], mesh_shape={})
    params_c = model_init(cfg_c, torch.Generator().manual_seed(0))
    feats_c = rng.uniform(size=(cfg_c.batch_size, cfg_c.seg_len,
                                cfg_c.feat_size)).astype(np.float32)
    x_c = torch.from_numpy(feats_c).to(dev)
    sw = (params_c["sub1"]["w"], params_c["sub1"]["b"], params_c["sub2"]["w"],
          params_c["sub2"]["b"], params_c["sub_proj"]["w"],
          params_c["sub_proj"]["b"])

    def stem_weights(F_, d_, dout_, seed):
        s_rng = np.random.default_rng(seed)
        return tuple(torch.from_numpy((s_rng.standard_normal(shape) * sc)
                                      .astype(np.float32)).to(dev)
                     for shape, sc in (((3, 3, 1, d_), 0.2), ((d_,), 0.1),
                                       ((3, 3, d_, d_), (9 * d_) ** -0.5),
                                       ((d_,), 0.1),
                                       ((F_ // 4 * d_, dout_),
                                        2 * (F_ // 4 * d_) ** -0.5),
                                       ((dout_,), 0.1)))
    x_t = x_c[:4].transpose(1, 2).contiguous().transpose(1, 2)
    stem_cases = [
        ("conformer_l", x_c, sw), ("ragged tile", x_c[:8, :1000], sw),
        ("strided x", x_t, sw), ("B = 0", x_c[:0], sw),
        ("F/4 = 3", x_c[:4, :400, :12], stem_weights(12, 512, 512, 3)),
        ("T = F = 8", x_c[:2, :8, :8], stem_weights(8, 128, 128, 4))]
    check(not x_t.is_contiguous(), "the strided stem case is contiguous")
    stem_err = 0.0
    for what, xs, ws_ in stem_cases:
        n0 = stem.launches
        got = stem.fused_stem(xs, *ws_)
        want = stem.fused_stem_plain(xs, *ws_)
        torch.cuda.synchronize()
        check(stem.launches == n0 + (xs.shape[0] > 0),
              f"fused_stem {what}: launches {stem.launches - n0}")
        check(tuple(got.shape) == tuple(want.shape) ==
              (xs.shape[0], xs.shape[1] // 4, ws_[4].shape[1])
              and bool(torch.isfinite(got).all()),
              f"fused_stem {what} output {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        scale = float(want.float().abs().max()) if want.numel() else 0.0
        tol = KERNEL_REL_TOL * max(1.0, scale)
        check(err <= tol, f"fused_stem {what}: {err} > {tol}")
        stem_err = max(stem_err, err)
        print(f"fused_stem {what} {list(xs.shape)} (strides {xs.stride()}) "
              f"-> {list(got.shape)}: max |kernel - plain| {err} (tolerance "
              f"{tol}, max |plain| {scale})", flush=True)
    del x_t, stem_cases
    # the device kernels of one call: the port's two, no library conv or
    # GEMM (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stem.fused_stem(x_c, *sw)
        torch.cuda.synchronize()
    dev_kernels = sorted({e.name for e in prof.events()
                          if e.device_type.name == "CUDA"})
    n_stem_kernels = sum(e.device_type.name == "CUDA" and (
        "stem_conv_kernel" in e.name or "stem_proj_kernel" in e.name)
        for e in prof.events())
    lib_kernels = [k for k in dev_kernels if "stem_" not in k and any(
        w in k.lower() for w in ("cudnn", "cublas", "gemm", "xmma", "cutlass",
                                 "conv", "sm90_", "sm80_"))]
    check(n_stem_kernels == 2 and not lib_kernels,
          f"fused_stem device kernels {dev_kernels}")
    print(f"fused_stem kernel launches per call: {n_stem_kernels} "
          f"(stem_conv_kernel, stem_proj_kernel); no library convolution or "
          f"GEMM among the call's device kernels ({len(dev_kernels)} names: "
          f"the rest cast and lay out the weights)", flush=True)
    # a traceback call (phase 2's inputs) is its kernel alone: it writes
    # the -1 cells itself, no memset before it
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_decode.traceback(ys_r, len_r, L)
        torch.cuda.synchronize()
    tb_dev = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    check(len(tb_dev) == 1 and "traceback_kernel" in tb_dev[0],
          f"a traceback call's device activity: {tb_dev}")
    print(f"traceback call's device activity: {tb_dev} (no memset)",
          flush=True)
    Bc, Tc, Fc = x_c.shape
    dc = sw[2].shape[-1]
    st_flops = 2 * Bc * (Tc // 2) * (Fc // 2) * dc * 9 \
        + 2 * Bc * (Tc // 4) * (Fc // 4) * dc * (9 * dc + dc)
    st_bytes = x_c.numel() * 4 + sum(w.numel() * 4 for w in sw) \
        + Bc * (Tc // 4) * dc * 2
    b_ms, b_by = bound(st_bytes, st_flops, BF16_TENSOR_FLOPS)
    stem_plain_ms = cuda_ms(lambda: stem.fused_stem_plain(x_c, *sw),
                            iters=3, warmup=1)
    report["fused_stem"] = dict(
        ms=cuda_ms(lambda: stem.fused_stem(x_c, *sw), iters=3, warmup=1),
        plain_ms=stem_plain_ms, library_ms=stem_plain_ms,
        library_call="the plain version: cuDNN conv1 and conv2 at bf16 + "
                     "clip, cuBLAS sub_proj",
        kernel_launches_per_call=n_stem_kernels,
        max_abs_err=stem_err, bound_ms=b_ms, bound_by=b_by)
    print(f"fused_stem [{Bc}, {Tc}, {Fc}] on {card}: "
          f"{report['fused_stem']['ms']:.4f} ms (conv1 inside, {n_stem_kernels}"
          f" kernel launches), plain {stem_plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)

    # 8c. the forward and decode as bench.py drives them
    def c_forward(**kw):
        with torch.no_grad():
            return model_apply(cfg_c, params_c, x_c,
                               compute_dtype="bfloat16", **kw)

    def c_decode(lp_in, **kw):
        return ctc_beam_search(lp_in, beam_width=cfg_c.beam_width,
                               blank_id=cfg_c.blank_id,
                               max_len=cfg_c.decode_max_len, **kw)

    decode_to_lists(c_decode(c_forward()))                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    lp_c = c_forward()
    res_c = c_decode(lp_c)
    tr_c = decode_to_lists(res_c)
    torch.cuda.synchronize()
    c_launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_blocks = len(params_c["blocks"])
    want_c = {"flash_mhsa_rel": n_blocks, "fused_stem": 0,
              "add_ln": 6 * n_blocks,
              "fused_prefix_decode": 1, "traceback": 1, "topk": 0,
              "traceback_overlay": 0, "rnn_scan": 0, "lstm_scan": 0}
    for name, n in want_c.items():
        check(c_launches[name] == n, f"conformer path launches of {name}: "
              f"{c_launches[name]}, expected {n}")
    print(f"conformer path launches per forward + decode: {c_launches}",
          flush=True)
    T4 = cfg_c.seg_len // 4
    check(tuple(lp_c.shape) == (T4, cfg_c.batch_size, cfg_c.output_size),
          f"conformer log_probs shape {tuple(lp_c.shape)}")
    check(bool(torch.isfinite(lp_c).all()), "conformer log_probs not finite")
    norm_err = float((lp_c.exp().sum(-1) - 1).abs().max())
    check(norm_err < 1e-4, "conformer log_probs rows do not normalise")
    res_cm = c_decode(lp_c, merge_impl="matched")
    for field in ("tokens", "lengths", "timesteps"):
        check(torch.equal(getattr(res_c, field), getattr(res_cm, field)),
              f"conformer decode: kernel and matched {field} differ")
    print(f"conformer_l log-probs {list(lp_c.shape)} finite, rows normalised "
          f"to {norm_err}; decode (W={cfg_c.beam_width}, V="
          f"{cfg_c.output_size}) == merge_impl='matched' (tokens, lengths, "
          f"timesteps); peak device memory {peak_gb:.2f} GB", flush=True)

    zero_counts()
    lp_cs = c_forward(stem_impl="pallas")
    decode_to_lists(c_decode(lp_cs))
    torch.cuda.synchronize()
    cs_launches = read_counts()
    check(cs_launches["fused_stem"] == 1 and
          cs_launches["flash_mhsa_rel"] == n_blocks,
          f"stem_impl='pallas' launches {cs_launches}")
    lp_cx = c_forward(attn_impl="xla")
    tr_cx = decode_to_lists(c_decode(lp_cx))
    tr_cs = decode_to_lists(c_decode(lp_cs))
    same_x = sum(a[0] == b[0] for a, b in zip(tr_c, tr_cx))
    same_s = sum(a[0] == b[0] for a, b in zip(tr_c, tr_cs))
    print(f"stem_impl='pallas' launches: {cs_launches}; against the default "
          f"forward: max |lp diff| {float((lp_cs - lp_c).abs().max())}, "
          f"transcripts equal {same_s} of {len(tr_c)}; attn_impl='xla' on the "
          f"card: max |lp diff| {float((lp_cx - lp_c).abs().max())}, "
          f"transcripts equal {same_x} of {len(tr_c)} (not gated: bf16 "
          f"roundings flip across 17 blocks)", flush=True)
    del lp_cs, lp_cx

    c_e2e_ms = host_ms(lambda: decode_to_lists(c_decode(c_forward())))
    c_e2e_s_ms = host_ms(lambda: decode_to_lists(c_decode(c_forward(
        stem_impl="pallas"))))
    c_fwd_ms = cuda_ms(c_forward, iters=3, warmup=1)
    c_fwd_s_ms = cuda_ms(lambda: c_forward(stem_impl="pallas"), iters=3,
                         warmup=1)
    c_fwd_x_ms = cuda_ms(lambda: c_forward(attn_impl="xla"), iters=3,
                         warmup=1)
    c_dec_ms = cuda_ms(lambda: c_decode(lp_c), iters=5, warmup=1)
    c_audio_s = cfg_c.batch_size * cfg_c.seg_len * 0.01
    mean_len_c = float(np.mean([len(ids) for ids, _ in tr_c]))
    print(f"conformer_l (B=64, T=1200, bf16, 17 blocks, beam 16) on {card}: "
          f"forward + decode + decode_to_lists {c_e2e_ms:.3f} ms (median of "
          f"5 whole calls, host clock) = {c_audio_s / (c_e2e_ms / 1e3):.1f} "
          f"audio-seconds/s ({c_audio_s:.0f} s of audio per call); forward "
          f"{c_fwd_ms:.3f} ms, forward with attn_impl='xla' {c_fwd_x_ms:.3f} "
          f"ms, decode {c_dec_ms:.3f} ms (CUDA events, means of 3 / 3 / 5); "
          f"mean transcript length {mean_len_c:.1f}", flush=True)
    print(f"conformer_l with stem_impl='pallas' (the fused stem kernel) on "
          f"{card}: forward + decode + decode_to_lists {c_e2e_s_ms:.3f} ms = "
          f"{c_audio_s / (c_e2e_s_ms / 1e3):.1f} audio-seconds/s, forward "
          f"{c_fwd_s_ms:.3f} ms; the default (stem_impl='auto': the plain "
          f"stem) {c_e2e_ms:.3f} / {c_fwd_ms:.3f} ms (reported, not gated: "
          f"the transcripts differ by bf16 flips)", flush=True)
    del params_c, x_c           # lp_c and res_c: phase 11e decodes them

    # ---- 9. the LSTM paths: deepspeech2 and bilstm_2x256
    def lstm_inputs(T_, B_, H_, seed):
        l_rng = np.random.default_rng(seed)

        def t(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)
        return (t(l_rng.standard_normal((T_, B_, 4 * H_)) * 0.5),
                t(l_rng.uniform(-1, 1, (H_, 4 * H_)) / H_ ** 0.5),
                t(np.tanh(l_rng.standard_normal((B_, H_)))),
                t(l_rng.standard_normal((B_, H_))))

    # 9a. the recurrence kernel against its plain version at the two
    # presets' shapes, forward and reverse, from zero state (as the path
    # runs it); one step from a random (h, c)
    lstm_err = 0.0
    for tag, (T_, B_, H_) in (("deepspeech2", (300, 32, 512)),
                              ("bilstm_2x256", (400, 16, 256))):
        for seed in LSTM_SEEDS:
            xw_, w_, h_, c_ = lstm_inputs(T_, B_, H_, seed)
            s_err = float((lstm_scan.lstm_scan(xw_[:1], w_, h_, c_)
                           - lstm_scan.lstm_scan_plain(xw_[:1], w_, h_, c_)
                           ).abs().max())
            check(s_err <= LSTM_STEP_TOL, f"lstm_scan step [{B_}, {H_}] "
                  f"differs by {s_err} (seed {seed})")
            z = torch.zeros_like(h_)
            errs = []
            for rev in (False, True):
                got = lstm_scan.lstm_scan(xw_, w_, z, z, reverse=rev)
                want = lstm_scan.lstm_scan_plain(xw_, w_, z, z, reverse=rev)
                check(bool(torch.isfinite(got).all()),
                      "lstm_scan output not finite")
                e = float((got - want).abs().max())
                check(e <= LSTM_SCAN_TOL, f"lstm_scan {tag} reverse={rev} "
                      f"differs from plain by {e} (seed {seed})")
                errs.append((e, float((got - want).abs().mean())))
            lstm_err = max(lstm_err, s_err, *(e for e, _ in errs))
            print(f"lstm_scan {tag} T={T_} B={B_} H={H_} seed {seed}: one "
                  f"step max |kernel - plain| {s_err} (tolerance "
                  f"{LSTM_STEP_TOL}); forward max {errs[0][0]}, mean "
                  f"{errs[0][1]}; reverse max {errs[1][0]}, mean "
                  f"{errs[1][1]} (tolerance {LSTM_SCAN_TOL})", flush=True)
    # B off the 16-row tile, and H padded inside the wrapper (200 -> 208):
    # the padded units stay exactly 0 and change no real unit's output;
    # B = 264 at deepspeech2's width: three batch groups, more than the
    # card holds at once for two directions (the bidir call's blocks walk
    # several, parking c between steps)
    for B_, H_ in ((24, 512), (24, 200), (264, 512)):
        xw_, w_, h_, c_ = lstm_inputs(50, B_, H_, B_ + H_)
        xb_, wb_, _, _ = lstm_inputs(50, B_, H_, B_ + H_ + 1)
        got_f = lstm_scan.lstm_scan(xw_, w_, h_, c_)
        got_b = lstm_scan.lstm_scan(xb_, wb_, h_, c_, reverse=True)
        e = max(float((got_f - lstm_scan.lstm_scan_plain(xw_, w_, h_, c_)
                       ).abs().max()),
                float((got_b - lstm_scan.lstm_scan_plain(
                    xb_, wb_, h_, c_, reverse=True)).abs().max()))
        check(e <= LSTM_SCAN_TOL, f"lstm_scan B={B_} H={H_}: {e}")
        bi = lstm_scan.lstm_scan_bidir(xw_, xb_, w_, wb_, h_, c_)
        check(torch.equal(bi, torch.cat([got_f, got_b], -1)),
              f"lstm_scan_bidir B={B_} H={H_} differs from two calls")
        lstm_err = max(lstm_err, e)
        msg = ""
        if H_ % 16:
            Hp = H_ + (-H_ % 16)
            pad = Hp - H_
            xw_p = F8.pad(xw_.view(50, B_, 4, H_), (0, pad)).view(
                50, B_, 4 * Hp)
            w_p = F8.pad(w_.view(H_, 4, H_), (0, pad, 0, 0, 0, pad)).view(
                Hp, 4 * Hp)
            got_p = lstm_scan.lstm_scan(xw_p, w_p, F8.pad(h_, (0, pad)),
                                        F8.pad(c_, (0, pad)))
            check(bool((got_p[..., H_:] == 0).all()),
                  "lstm_scan: a padded unit left 0")
            check(torch.equal(got_p[..., :H_], got_f),
                  "lstm_scan: padded units changed a real unit")
            msg = f"; padded units ({H_} -> {Hp}) stay 0, real units equal"
        print(f"lstm_scan T=50 B={B_} H={H_}: max |kernel - plain| {e} "
              f"(forward and reverse); lstm_scan_bidir == two calls{msg}",
              flush=True)

    # time at deepspeech2's shape, one layer: one direction, both
    # directions in one call (the path's), the plain version, and
    # torch.nn.LSTM (cuDNN, bf16, one layer and one direction, input 2H:
    # its time includes its own input projection) as the yardstick
    T_, B_, H_ = 300, 32, 512
    xw_, w_, _, _ = lstm_inputs(T_, B_, H_, 1)
    xb_, wb_, _, _ = lstm_inputs(T_, B_, H_, 2)
    z = torch.zeros(B_, H_, device=dev)
    nn_lstm = torch.nn.LSTM(2 * H_, H_).to(dev, torch.bfloat16)
    nn_lstm.flatten_parameters()      # one weight buffer, as cuDNN wants
    x_lib = torch.from_numpy(rng.standard_normal((T_, B_, 2 * H_)).astype(
        np.float32)).to(dev, torch.bfloat16)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: nn_lstm(x_lib), iters=5)
    b_ms, b_by = bound(T_ * B_ * 4 * H_ * 4 + T_ * B_ * H_ * 4
                       + H_ * 4 * H_ * 2 + 2 * B_ * H_ * 4,
                       2 * T_ * B_ * H_ * 4 * H_, BF16_TENSOR_FLOPS)
    n0 = lstm_scan.launches
    lstm_scan.lstm_scan_bidir(xw_, xb_, w_, wb_, z, z)
    per_call = lstm_scan.launches - n0
    check(per_call == 1, f"lstm_scan_bidir launched {per_call} kernels a "
          f"call")
    report["lstm_scan"] = dict(
        kernel_launches_per_call=per_call,
        ms=cuda_ms(lambda: lstm_scan.lstm_scan(xw_, w_, z, z), iters=5),
        ms_bidir=cuda_ms(lambda: lstm_scan.lstm_scan_bidir(
            xw_, xb_, w_, wb_, z, z), iters=5),
        plain_ms=cuda_ms(lambda: lstm_scan.lstm_scan_plain(xw_, w_, z, z),
                         iters=2, warmup=1),
        library_ms=lib_ms,
        library_call="torch.nn.LSTM(1024, 512) bf16 on [300, 32, 1024] "
                     "(cuDNN; includes its input projection)",
        max_abs_err=lstm_err, bound_ms=b_ms, bound_by=b_by)
    print(f"lstm_scan deepspeech2 layer (T=300, B=32, H=512) on {card}: one "
          f"direction {report['lstm_scan']['ms']:.4f} ms (1 launch), both "
          f"directions in one call {report['lstm_scan']['ms_bidir']:.4f} ms "
          f"(1 launch), plain {report['lstm_scan']['plain_ms']:.4f} ms, "
          f"torch.nn.LSTM bf16 {lib_ms:.4f} ms, bound per direction "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    del xw_, xb_, w_, wb_, x_lib, nn_lstm

    def lstm_path(preset):
        """Pipeline.transcribe on the preset at full size with
        rnn_impl="pallas": launches of one counted run, log-probs and
        decode checks, timings."""
        cfg_l = dataclasses.replace(PRESETS[preset], rnn_impl="pallas")
        params_l = model_init(cfg_l, torch.Generator().manual_seed(0))
        pipe_l = Pipeline(cfg_l, params=params_l)
        x_l = torch.from_numpy(rng.uniform(size=(
            cfg_l.batch_size, cfg_l.seg_len, cfg_l.feat_size)).astype(
                np.float32)).to(dev)
        pipe_l.transcribe(x_l)                             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out_l = pipe_l.transcribe(x_l)
        torch.cuda.synchronize()
        got = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        lp_l = pipe_l.log_probs(x_l)
        T_out = lp_l.shape[0]
        want = {name: 0 for name in counters}
        want.update(lstm_scan=cfg_l.rnn_num_layers,
                    fused_prefix_decode=1, traceback=1)
        for name, n in want.items():
            check(got[name] == n, f"{preset} launches of {name}: "
                  f"{got[name]}, expected {n}")
        print(f"{preset} path launches per transcribe: {got} (lstm_scan = "
              f"{cfg_l.rnn_num_layers} layers, one launch a layer for both "
              f"directions and all {T_out} steps)", flush=True)
        check(tuple(lp_l.shape) == (T_out, cfg_l.batch_size,
                                    cfg_l.output_size),
              f"{preset} log_probs shape {tuple(lp_l.shape)}")
        check(bool(torch.isfinite(lp_l).all()),
              f"{preset} log_probs not finite")
        norm = float((lp_l.exp().sum(-1) - 1).abs().max())
        check(norm < 1e-4, f"{preset} log_probs rows do not normalise")

        def decode(**kw):
            return ctc_beam_search(lp_l, beam_width=cfg_l.beam_width,
                                   max_len=cfg_l.decode_max_len, **kw)
        res_k, res_m = decode(), decode(merge_impl="matched")
        for field in ("tokens", "lengths", "timesteps"):
            check(torch.equal(getattr(res_k, field), getattr(res_m, field)),
                  f"{preset} decode: kernel and matched {field} differ")
        check([ids for ids, _ in out_l] ==
              [ids for ids, _ in decode_to_lists(res_k)],
              f"{preset} transcribe differs from its own stages")
        e2e = host_ms(lambda: pipe_l.transcribe(x_l))
        fwd = cuda_ms(lambda: pipe_l.log_probs(x_l), iters=3, warmup=1)
        dec = host_ms(lambda: decode_to_lists(decode()))
        audio = cfg_l.batch_size * cfg_l.seg_len * 0.01
        split = lstm_stages(params_l, x_l, lp_l)
        mean_len = float(np.mean([len(ids) for ids, _ in out_l]))
        print(f"transcribe {preset} (B={cfg_l.batch_size}, T="
              f"{cfg_l.seg_len}, rnn_impl=pallas, beam {cfg_l.beam_width}) "
              f"on {card}: {e2e:.3f} ms (median of 5 whole calls, host "
              f"clock) = {audio / (e2e / 1e3):.1f} audio-seconds/s "
              f"({audio:.0f} s of audio per call); log-probs "
              f"{list(lp_l.shape)} finite, rows normalised to {norm}; "
              f"decode == merge_impl='matched'; forward {fwd:.3f} ms (CUDA "
              f"events, mean of 3)"
              + "".join(f", {k} {v:.3f} ms" for k, v in split.items())
              + f"; decode {dec:.3f} ms (median of 5, host clock incl. D2H "
              f"and lists); peak device memory {peak:.2f} GB; mean "
              f"transcript length {mean_len:.1f}", flush=True)
        return got

    def lstm_stages(params_l, x_l, lp_l):
        """CUDA-event ms of the forward's stages (DS2's convs, the LSTM
        layers' input GEMMs and recurrence kernels, the head), each timed
        alone on the inputs the forward gives it (mean of 3).

        The stages mirror `ds2_apply` / `bilstm_apply` and `lstm_forward`
        with impl="pallas" step by step and must change with them; their
        composition is held bit-equal to the path's log-probs `lp_l`, so
        a drift fails the check instead of skewing the split."""
        with torch.no_grad():
            out = {}
            h = x_l.transpose(0, 1)
            if "conv1" in params_l:
                def convs():
                    h = conv2d(params_l["conv1"], x_l[..., None], (2, 2))
                    return conv2d(params_l["conv2"], h, (1, 2))
                out["convs"] = cuda_ms(convs, iters=3, warmup=1)
                h = convs()
                h = h.reshape(h.shape[0], h.shape[1], -1).transpose(0, 1)
            z = torch.zeros(h.shape[1], params_l["lstm"]["layers"][0][
                "w_hh"].shape[0], device=dev)
            gemm = rec = 0.0
            for cf, cb in zip(params_l["lstm"]["layers"],
                              params_l["lstm"]["layers_rev"]):
                def proj(h=h, cf=cf, cb=cb):
                    return _input_projection(cf, h), _input_projection(cb, h)
                gemm += cuda_ms(proj, iters=3, warmup=1)
                xf, xb = proj()
                rec += cuda_ms(lambda: lstm_scan.lstm_scan_bidir(
                    xf, xb, cf["w_hh"], cb["w_hh"], z, z), iters=3, warmup=1)
                h = lstm_scan.lstm_scan_bidir(xf, xb, cf["w_hh"],
                                              cb["w_hh"], z, z)
            out["input GEMMs"] = gemm
            out["lstm_scan kernels"] = rec
            def head():
                return torch.log_softmax(linear(params_l["proj"], h, None),
                                         -1)
            out["proj + log_softmax"] = cuda_ms(head, iters=3, warmup=1)
            check(torch.equal(head(), lp_l),
                  "the stage split does not compose to the path's log-probs")
        return out

    # 9b. deepspeech2 (B=32, T=600 -> T'=300, F=160, 5 BiLSTM layers of
    # H=512, W=32); 9c. bilstm_2x256 (B=16, T=400, F=80, 2 layers, W=10)
    d_launches = lstm_path("deepspeech2")
    b_launches = lstm_path("bilstm_2x256")

    # 9d. small DS2 and BiLSTM forwards, card against CPU, over FWD_SEEDS
    for preset, over in (("deepspeech2", dict(seg_len=40, input_size=80)),
                         ("bilstm_2x256", dict(seg_len=40))):
        for seed in FWD_SEEDS:
            c = dataclasses.replace(PRESETS[preset], device="cpu",
                                    batch_size=8, rnn_hidden_size=128,
                                    rnn_num_layers=2, **over)
            f_small = np.random.default_rng(seed).uniform(
                size=(8, c.seg_len, c.feat_size)).astype(np.float32)
            errs = {}
            for impl in ("scan", "pallas"):
                ci = dataclasses.replace(c, rnn_impl=impl)
                lp_cpu = Pipeline(ci, generator=torch.Generator().manual_seed(
                    seed)).log_probs(f_small)
                n0 = lstm_scan.launches
                lp_gpu = Pipeline(dataclasses.replace(ci, device="cuda"),
                                  generator=torch.Generator().manual_seed(
                                      seed)).log_probs(f_small)
                n_k = lstm_scan.launches - n0
                check(n_k == (c.rnn_num_layers if impl == "pallas" else 0),
                      f"small {preset} rnn_impl={impl}: {n_k} lstm_scan "
                      f"launches")
                errs[impl] = float((lp_gpu.cpu() - lp_cpu).abs().max())
                check(errs[impl] <= FWD_LSTM_CARD_CPU_TOL[impl],
                      f"small {preset} card vs CPU, rnn_impl={impl}, seed "
                      f"{seed}: {errs[impl]}")
                # forward + decode on the CPU against both on the card
                r_cpu = decode_to_lists(ctc_beam_search(lp_cpu, beam_width=8))
                r_gpu = decode_to_lists(ctc_beam_search(lp_gpu, beam_width=8))
                check([ids for ids, _ in r_cpu] == [ids for ids, _ in r_gpu],
                      f"small {preset} transcripts card vs CPU differ, "
                      f"rnn_impl={impl}, seed {seed}")
            print(f"small {preset} forward (B=8, T={c.seg_len}, H=128, 2 "
                  f"layers) card vs CPU, seed {seed}: max err rnn_impl=scan "
                  f"{errs['scan']} (tolerance {FWD_LSTM_CARD_CPU_TOL['scan']}"
                  f"), pallas {errs['pallas']} (tolerance "
                  f"{FWD_LSTM_CARD_CPU_TOL['pallas']}); transcripts of "
                  f"forward + decode equal, card vs CPU, both rnn_impl",
                  flush=True)

    # ---- 10. bigram shallow fusion and audio in, text out
    # 10a. the decode kernel's LM variant against its plain version at the
    # flagship shape (T=200, B=256, V=47, W=100) on phase 2's log-probs,
    # with a standard-normal table and a bigram table from a seeded corpus
    T, B, V, W = 200, 256, 47, 100
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz'"),
                                int(rng.integers(1, 8))))
             for _ in range(300)]
    corpus = [" ".join(rng.choice(words, int(rng.integers(3, 12))))
              for _ in range(200)]
    lm_text = bigram_bias_from_text(corpus, V)
    lm_text[::4, ::5] = -0.0          # the quantization turns these to +0.0
    tables = {"normal": rng.standard_normal((V + 1, V)).astype(np.float32),
              "bigram": lm_text}

    def lm_check(lp_in, lm_q, W_, tag):
        """Kernel against plain with the table at beam W_: ys equal, the
        final state equal in its bits; returns the kernel's ys."""
        init = _init_beam(lp_in.shape[1], W_, dev)
        fin_k, ys_k = fused_decode.fused_prefix_decode(lp_in, init,
                                                       lm_q=lm_q)
        fin_p, ys_p = fused_decode.fused_prefix_decode_plain(lp_in, init,
                                                             lm_q=lm_q)
        torch.cuda.synchronize()
        check(torch.equal(ys_k, ys_p), f"LM decode ys differ ({tag})")
        for name in fused_decode.FIELDS:
            a, b = getattr(fin_k, name), getattr(fin_p, name)
            if name in ("s1", "s2"):
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a.long(), b.long()),
                  f"LM decode final {name} differs in its bits ({tag})")
        return ys_k

    lm_err = 0.0
    for t_name, table in tables.items():
        lm_q = _quantize_lm(torch.from_numpy(table), V, dev)
        for l_name, lp_np in (("random", lp_rand), ("tie-heavy relu",
                                                   lp_ties)):
            lp_in = torch.from_numpy(lp_np).to(dev)
            tag = f"{t_name} table, {l_name} log-probs"
            ys_k = lm_check(lp_in, lm_q, W, tag)
            res_lm = ctc_beam_search(lp_in, beam_width=W, max_len=L,
                                     lm_bias=lm_q)
            res_lm_p = ctc_beam_search(lp_in, beam_width=W, max_len=L,
                                       lm_bias=lm_q, merge_impl="matched")
            for field in ("tokens", "lengths", "timesteps"):
                check(torch.equal(getattr(res_lm, field),
                                  getattr(res_lm_p, field)),
                      f"LM ctc_beam_search {field} differ ({tag})")
            err = float((res_lm.scores - res_lm_p.scores).abs().max())
            check(err <= DECODE_SCORE_TOL, f"LM scores differ by {err} "
                  f"({tag})")
            lm_err = max(lm_err, err)
            _, ys_n = fused_decode.fused_prefix_decode(
                lp_in, _init_beam(B, W, dev))
            check(not torch.equal(ys_k, ys_n),
                  f"the LM decode equals the decode without it ({tag})")
            print(f"LM decode kernel (T={T}, B={B}, V={V}, W={W}, {tag}): "
                  f"ys and final state bit-equal to the plain version; "
                  f"scores err {err} (tolerance {DECODE_SCORE_TOL}); differs "
                  f"from the decode without the LM", flush=True)
    lm_q47 = _quantize_lm(torch.from_numpy(tables["bigram"]), V, dev)
    init_lm = _init_beam(B, W, dev)
    nb_lm = (T * B * V * 4 + 2 * 9 * B * W * 4 + T * B * W * 4
             + (V + 1) * V * 4)
    b_ms, b_by = bound(nb_lm, T * B * (3 * W * V + 30 * W), F32_FLOPS)
    lm_report = dict(
        ms=cuda_ms(lambda: fused_decode.fused_prefix_decode(
            lp_r, init_lm, lm_q=lm_q47), iters=5, warmup=1),
        ms_no_lm=cuda_ms(lambda: fused_decode.fused_prefix_decode(
            lp_r, init_lm), iters=5, warmup=1),
        plain_ms=cuda_ms(lambda: fused_decode.fused_prefix_decode_plain(
            lp_r, init_lm, lm_q=lm_q47), iters=1, warmup=1),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=lm_err, library_ms=None)
    print(f"LM decode kernel at T={T}, B={B}, V={V}, W={W} on {card}: "
          f"{lm_report['ms']:.4f} ms with the bigram table, "
          f"{lm_report['ms_no_lm']:.4f} ms without (CUDA events, mean of 5; "
          f"ratio {lm_report['ms'] / lm_report['ms_no_lm']:.3f}), plain "
          f"{lm_report['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"lp + ys + state + table)", flush=True)

    # 10b. the LM envelope's edges: conformer_s's decode shape (V=129,
    # W=64, B=32, T=600), JAX's LM ceiling V=255 (W=64), and V=256, where
    # "auto" takes the matched scan and "pallas" refuses
    for V_, W_, B_, T_ in ((129, 64, 32, 600), (255, 64, 16, 100)):
        lp_e = torch.from_numpy(log_softmax_np(
            rng.standard_normal((T_, B_, V_)))).to(dev)
        lm_e = _quantize_lm(torch.from_numpy(rng.standard_normal(
            (V_ + 1, V_)).astype(np.float32)), V_, dev)
        lm_check(lp_e, lm_e, W_, f"V={V_}, W={W_}")
        init_e = _init_beam(B_, W_, dev)
        e_ms = cuda_ms(lambda: fused_decode.fused_prefix_decode(
            lp_e, init_e, lm_q=lm_e), iters=3, warmup=1)
        e_ms_n = cuda_ms(lambda: fused_decode.fused_prefix_decode(
            lp_e, init_e), iters=3, warmup=1)
        lm_report[f"ms_V{V_}_W{W_}_B{B_}_T{T_}"] = e_ms
        lm_report[f"ms_no_lm_V{V_}_W{W_}_B{B_}_T{T_}"] = e_ms_n
        print(f"LM decode kernel V={V_}, W={W_}, B={B_}, T={T_}: ys and final "
              f"state bit-equal to the plain version; {e_ms:.4f} ms with the "
              f"table, {e_ms_n:.4f} ms without (CUDA events, mean of 3)",
              flush=True)
    lp_256 = torch.from_numpy(log_softmax_np(
        rng.standard_normal((8, 4, 256)))).to(dev)
    lm_256 = torch.from_numpy(rng.standard_normal((257, 256)).astype(
        np.float32)).to(dev)
    zero_counts()
    res_256 = ctc_beam_search(lp_256, beam_width=16, max_len=16,
                              lm_bias=lm_256)
    torch.cuda.synchronize()
    check(read_counts()["fused_prefix_decode"] == 0,
          "V=256 with an LM under 'auto' launched the decode kernel")
    res_256m = ctc_beam_search(lp_256, beam_width=16, max_len=16,
                               lm_bias=lm_256, merge_impl="matched")
    check(all(torch.equal(getattr(res_256, f), getattr(res_256m, f))
              for f in res_256._fields), "V=256 'auto' differs from matched")
    try:
        ctc_beam_search(lp_256, beam_width=16, lm_bias=lm_256,
                        merge_impl="pallas")
        check(False, "V=256 with an LM under 'pallas' did not raise")
    except ValueError as e:
        print(f"V=256 with an LM: 'auto' made no decode launch and equals "
              f"'matched'; 'pallas' raises: {e}", flush=True)

    # 10c. the LM stream: reference_large's log-probs (phase 6) in 10 chunks
    # of 20 frames with the bigram table, against the batch LM decode
    def lm_stream(lp_in):
        st = streaming_init(cfg.batch_size, W, max_len=L, device=dev)
        for i in range(n_chunks):
            st, snap = streaming_step(
                st, lp_in[i * STREAM_TC:(i + 1) * STREAM_TC], lm_bias=lm_q47)
        return snap

    lm_stream(lp)                                        # warm-up
    torch.cuda.synchronize()
    zero_counts()
    snap_lm = lm_stream(lp)
    torch.cuda.synchronize()
    lms_launches = read_counts()
    for name, n in {"fused_prefix_decode": n_chunks,
                    "fused_prefix_decode_lm": n_chunks,
                    "traceback_overlay": n_chunks, "traceback": 0}.items():
        check(lms_launches[name] == n, f"LM streaming launches of {name}: "
              f"{lms_launches[name]}, expected {n}")
    batch_lm = ctc_beam_search(lp, beam_width=W, max_len=L, lm_bias=lm_q47)
    for field in ("tokens", "lengths", "timesteps", "overflow"):
        check(torch.equal(getattr(snap_lm, field), getattr(batch_lm, field)),
              f"LM stream {field} differ from the batch LM decode")
    check(torch.equal(snap_lm.scores.view(torch.int32),
                      batch_lm.scores.view(torch.int32)),
          "LM stream scores differ from the batch LM decode in their bits")
    lms_ms = host_ms(lambda: lm_stream(lp))
    print(f"LM streaming decode reference_large ({n_chunks} x {STREAM_TC} "
          f"frames, bigram table) == batch LM decode (tokens, lengths, "
          f"timesteps, overflow, score bits); launches {lms_launches}; whole "
          f"stream {lms_ms:.3f} ms (median of 5, host clock)", flush=True)

    # 10d. Pipeline.transcribe_audio on reference_large (rnn_impl="pallas",
    # H=2048, V=47, W=100): B=256 tone-speech waveforms (the synthesis of
    # tests/test_audio_anchor.py, one sine per symbol of 14 frames, no
    # symbol twice in a row, noise 0.02) of 1.0-2.0 s at 16 kHz
    SR, HOP = 16000, 160
    seg = 14 * HOP
    tone = np.sin(2 * np.pi * np.array([500.0, 1200.0, 2600.0, 5200.0])
                  [:, None] * np.arange(seg)[None, :] / SR)
    n_samples = rng.integers(SR, 2 * SR + 1, cfg.batch_size)
    waves, texts = [], []
    for n in n_samples:
        syms = []
        while len(syms) * seg < n:
            s = int(rng.integers(1, 5))
            if not syms or s != syms[-1]:
                syms.append(s)
        w = np.concatenate([tone[s - 1] for s in syms])[:n]
        waves.append((w + rng.standard_normal(n) * 0.02).astype(np.float32))
        texts.append(ids_to_text(syms))
    audio_s_real = float(n_samples.sum()) / SR

    # the card's log-mel (cuFFT) against the native one the path runs,
    # on every utterance's valid frames (frames depend only on their
    # own samples, so the zero-padded batch gives them exactly)
    wav_b = torch.zeros(len(waves), int(n_samples.max()), device=dev)
    for i, w in enumerate(waves):
        wav_b[i, :w.size] = torch.from_numpy(w)
    lm_card = logmel_torch(wav_b, n_mels=cfg.input_size)
    logmel_err = 0.0
    for i, w in enumerate(waves):
        ref = torch.from_numpy(native.logmel(w, n_mels=cfg.input_size))
        logmel_err = max(logmel_err, float(
            (lm_card[i, :ref.shape[0]].cpu() - ref).abs().max()))
    check(logmel_err <= LOGMEL_TOL, f"logmel_torch on the card differs from "
          f"the native log-mel by {logmel_err}")
    logmel_card_ms = cuda_ms(lambda: logmel_torch(wav_b,
                                                  n_mels=cfg.input_size))
    print(f"logmel_torch on the card (cuFFT) vs the native log-mel, "
          f"{len(waves)} utterances of 1.0-2.0 s, {cfg.input_size} mels: max "
          f"|diff| {logmel_err} (tolerance {LOGMEL_TOL}); batched on the "
          f"card {logmel_card_ms:.4f} ms (CUDA events; not on the path)",
          flush=True)

    def audio_path(cmvn):
        """transcribe_audio with cmvn off (the preset) or on: launches of
        one counted call, the kernel decode against the plain decode on
        the same log-probs and lengths, stage times."""
        pipe_a = Pipeline(dataclasses.replace(cfg, cmvn=cmvn), params=params)
        pipe_a.transcribe_audio(waves)                   # warm-up
        torch.cuda.synchronize()
        zero_counts()
        out_a = pipe_a.transcribe_audio(waves)
        torch.cuda.synchronize()
        got = read_counts()
        x_a, lens_a = pipe_a.audio_features(waves)
        T_pad = x_a.shape[1]
        want = {name: 0 for name in counters}
        want.update(rnn_scan=cfg.rnn_num_layers, fused_prefix_decode=1,
                    traceback=1)
        for name, n in want.items():
            check(got[name] == n, f"transcribe_audio (cmvn={cmvn}) launches "
                  f"of {name}: {got[name]}, expected {n}")
        check(tuple(x_a.shape) == (len(waves), T_pad, cfg.feat_size)
              and lens_a.tolist() == [1 + (int(n) - 512) // HOP
                                      for n in n_samples],
              f"audio features {tuple(x_a.shape)}")
        lp_a = pipe_a.log_probs(x_a)
        check(tuple(lp_a.shape) == (T_pad, len(waves), cfg.output_size)
              and bool(torch.isfinite(lp_a).all()),
              f"transcribe_audio log_probs {tuple(lp_a.shape)}")

        def decode(**kw):
            return ctc_beam_search(lp_a, beam_width=cfg.beam_width,
                                   max_len=cfg.decode_max_len,
                                   input_lengths=lens_a, **kw)
        tr_k = [pipe_a.to_text(ids) for ids, _ in decode_to_lists(decode())]
        tr_p = [pipe_a.to_text(ids) for ids, _ in
                decode_to_lists(decode(merge_impl="matched"))]
        check(tr_k == tr_p, f"transcribe_audio (cmvn={cmvn}): kernel and "
              f"plain decode transcripts differ")
        check(out_a == tr_k, f"transcribe_audio (cmvn={cmvn}) differs from "
              f"its own stages")
        times = dict(
            front=host_ms(lambda: pipe_a.audio_features(waves)),
            forward=cuda_ms(lambda: pipe_a.log_probs(x_a), iters=3,
                            warmup=1),
            decode=host_ms(lambda: decode_to_lists(decode())),
            whole=host_ms(lambda: pipe_a.transcribe_audio(waves)))
        print(f"transcribe_audio reference_large (B={len(waves)}, cmvn={cmvn}, "
              f"rnn_impl=pallas, padded T={T_pad}) on {card}: launches {got}; "
              f"whole call {times['whole']:.3f} ms (median of 5, host clock) "
              f"= {audio_s_real / (times['whole'] / 1e3):.1f} audio-seconds/s "
              f"over the real {audio_s_real:.2f} s of audio; front end ({len(waves)} "
              f"native log-mels, padding, copy{', cmvn' if cmvn else ''}, "
              f"context) {times['front']:.3f} ms (median of 5, host clock), "
              f"forward {times['forward']:.3f} ms (CUDA events, mean of 3), "
              f"decode {times['decode']:.3f} ms (median of 5, host clock incl. "
              f"D2H and lists); kernel decode == plain decode (transcripts)",
              flush=True)
        return got, lp_a

    a_launches, lp_audio = audio_path(cmvn=False)
    ac_launches, _ = audio_path(cmvn=True)

    # 10e. evaluate_batch with a bigram LM on 10d's log-probs; the
    # references are the synthesized texts (random weights: the WER value
    # means nothing, the check is kernel against plain)
    lm_ref = bigram_bias_from_text(texts, cfg.output_size, weight=0.5)
    zero_counts()
    ev_lm = evaluate_batch(lp_audio, texts, beam_width=cfg.beam_width,
                           lm_bias=torch.from_numpy(lm_ref).to(dev))
    torch.cuda.synchronize()
    ev_launches = read_counts()
    check(ev_launches["fused_prefix_decode_lm"] == 1,
          f"evaluate_batch with an LM launches {ev_launches}")
    hyps_p = [ids_to_text(ids) for ids, _ in decode_to_lists(ctc_beam_search(
        lp_audio, beam_width=cfg.beam_width, merge_impl="matched",
        lm_bias=torch.from_numpy(lm_ref).to(dev)))]
    check(ev_lm["hyps"] == hyps_p, "evaluate_batch LM hypotheses differ "
          "between the kernel and the plain decode")
    ev_no = evaluate_batch(lp_audio, texts, beam_width=cfg.beam_width)
    print(f"evaluate_batch on the transcribe_audio log-probs (B="
          f"{len(texts)}, W={cfg.beam_width}): WER {ev_no['wer']:.4f} without "
          f"the LM, {ev_lm['wer']:.4f} with a bigram table of the references "
          f"(weight 0.5): random weights, so the values mean nothing; LM "
          f"hypotheses of the kernel decode == the plain decode's; launches "
          f"{ev_launches}", flush=True)

    # ---- 11. the vocab-sharded (tensor-parallel) decode on one card: a
    # mesh whose n model shards all sit on cuda:0 (parallel/mesh.py)
    T, B, V, W = 200, 256, 47, 100
    F_LAST = fused_decode.FIELDS.index("last")

    def tp_mesh(shape):
        return make_mesh(shape, devices=[dev] * int(np.prod(list(
            shape.values()))))

    def max_err(got, want):
        return max(float((a.double() - b.double()).abs().max())
                   if a.numel() else 0.0 for a, b in zip(got, want))

    def same_result(got, want, what):
        for field in want._fields:
            a, b = getattr(got, field), getattr(want, field)
            if field == "scores":
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b), f"{what}: {field} differ")

    # 11a. tp_frame against its plain version from a mid-decode state (5
    # frames of the single-card kernel), every shard: the flagship shape
    # at n = 4 and 1 (shards 1-3 of n = 4 hold no blank) and with the blank
    # at 23, conformer_l's decode shape (B=64, V=129, W=16) at n = 2 and 4
    def tp_frame_check(lp_in, W_, n_, blank, tag):
        V_ = lp_in.shape[2]
        beam, _ = fused_decode.fused_prefix_decode(
            lp_in[:5], _init_beam(lp_in.shape[1], W_, dev), blank)
        st = fused_decode.pack_state(beam)
        f = lp_in[5]
        f_last = torch.gather(f, 1, st[F_LAST].long().clamp(0, V_ - 1))
        f_blank = f[:, blank].contiguous()
        err, args = 0.0, []
        for lo, hi in fused_decode.shard_bounds(V_, n_):
            a = (f[:, lo:hi], f_last, f_blank, st, lo, hi, V_, blank)
            got = fused_decode.tp_frame(*a)
            want = fused_decode.tp_frame_plain(*a)
            torch.cuda.synchronize()
            for x, y, what in zip(got, want, ("ys", "keys", "fields")):
                check(torch.equal(x, y), f"tp_frame {what} differ from the "
                      f"plain version ({tag}, window [{lo}, {hi}))")
            err = max(err, max_err(got, want))
            args.append(a)
        print(f"tp_frame == plain ({tag}, every shard): ys, keys, fields "
              f"(score bits) equal", flush=True)
        return err, args

    tpf_err = 0.0
    for lp_in, W_, n_, blank, tag in (
            (lp_r, W, 4, 0, "B=256 V=47 W=100 n=4"),
            (lp_r, W, 1, 0, "B=256 V=47 W=100 n=1"),
            (lp_r, W, 4, 23, "B=256 V=47 W=100 n=4 blank=23"),
            (lp_c, 16, 2, 0, "B=64 V=129 W=16 n=2"),
            (lp_c, 16, 4, 0, "B=64 V=129 W=16 n=4")):
        e, a = tp_frame_check(lp_in, W_, n_, blank, tag)
        tpf_err = max(tpf_err, e)
        if tag == "B=256 V=47 W=100 n=4":
            tpf_args = a[1]                      # a window without the blank
    Vw = tpf_args[5] - tpf_args[4]
    nb = (2 * 9 * B * W * 4 + B * W * 4 + B * 4 + B * Vw * 4 + B * W * 4
          + B * W * 8)
    b_ms, b_by = bound(nb, B * (2 * W * Vw + 30 * W), F32_FLOPS)
    report["tp_frame"] = dict(
        ms=cuda_ms(lambda: fused_decode.tp_frame(*tpf_args), iters=20),
        plain_ms=cuda_ms(lambda: fused_decode.tp_frame_plain(*tpf_args),
                         iters=3, warmup=1),
        library_ms=None, max_abs_err=tpf_err, bound_ms=b_ms, bound_by=b_by)

    # 11b. tp_scan in both designs where they apply on the one card (the
    # cluster design up to its limit, the push design at any n): each at
    # the flagship shape with n = 1, 2, 4 (and 8) against
    # fused_prefix_decode (n = 1: JAX's mesh-of-1 probe) and against
    # tp_scan_plain at T = 40; conformer_l's decode shape (V = 129, W = 16:
    # n = 2, 4, 8) likewise; ms per design and shard count beside row 2, in
    # turns
    init_p = fused_decode.pack_state(init_r)
    fin1, ys1 = fused_decode.fused_prefix_decode(lp_r, init_r)
    init_c = _init_beam(lp_c.shape[1], 16, dev)
    fin_c1, ys_c1 = fused_decode.fused_prefix_decode(lp_c, init_c)
    tps_err = 0.0
    tp_limit = {}
    for lp_in, init_in, (beam, ys_s), ns, tag in (
            (lp_r, init_r, (fin1, ys1), (1, 2, 4, 8),
             "T=200 B=256 V=47 W=100"),
            (lp_c, init_c, (fin_c1, ys_c1), (2, 4, 8),
             "T=300 B=64 V=129 W=16")):
        pk = fused_decode.pack_state(init_in)
        W_, V_ = init_in.s1.shape[1], lp_in.shape[2]
        limit = tp_limit[tag] = fused_decode.tp_cluster_limit(dev, W_, V_)
        check(limit >= 8, f"tp_scan cluster limit {limit} at {tag}")
        for n_ in ns:
            want = fused_decode.tp_scan_plain(lp_in[:40], pk, n_)
            for design in ("cluster", "push"):
                what = f"{tag} n={n_} {design}"
                got = fused_decode.tp_scan(lp_in[:40], pk, [dev] * n_,
                                           design=design)
                torch.cuda.synchronize()
                for x, y, name_ in zip(got, want, ("final states", "ys")):
                    check(torch.equal(x, y), f"tp_scan {name_} differ from "
                          f"the plain version ({what}, T=40)")
                tps_err = max(tps_err, max_err(got, want))
                fins, ys_tp = fused_decode.tp_scan(lp_in, pk, [dev] * n_,
                                                   design=design)
                torch.cuda.synchronize()
                check(torch.equal(ys_tp, ys_s), f"tp_scan ys differ from "
                      f"fused_prefix_decode ({what})")
                for s_ in range(n_):
                    check(torch.equal(fins[s_], fused_decode.pack_state(beam)),
                          f"tp_scan shard {s_}'s final state differs from "
                          f"fused_prefix_decode's ({what})")
        print(f"tp_scan ({tag}; cluster limit {limit}) cluster and push "
              f"designs at n={list(ns)}: ys and every shard's final state "
              f"bit-equal to fused_prefix_decode and to tp_scan_plain at T=40",
              flush=True)
    scan_runs = {"fused_prefix_decode (row 2)":
                 lambda: fused_decode.fused_prefix_decode(lp_r, init_r)}
    for n_ in (1, 2, 4, 8):
        for design in ("cluster", "push"):
            scan_runs[f"{design} n={n_}"] = (
                lambda n_=n_, design=design: fused_decode.tp_scan(
                    lp_r, init_p, [dev] * n_, design=design))
    scan_ms = {k: [] for k in scan_runs}
    for _ in range(2):                           # in turns with row 2
        for k in list(scan_runs) + list(reversed(scan_runs)):
            scan_ms[k].append(cuda_ms(scan_runs[k], iters=3, warmup=1))
    ms_by = {k: min(v) for k, v in scan_ms.items()}
    auto4 = fused_decode.pick_design(4, 1, W, V, tp_limit[
        "T=200 B=256 V=47 W=100"])
    # the bound counts what the function needs in device memory: log-probs
    # and the initial state in, ys and every shard's final state out. The
    # shards' exchanged keys (each list written once into each of the 3
    # peers' inboxes) stay apart: on one card they pass through L2 or
    # shared memory, for which the data sheet gives no rate, and across
    # cards through NVLink
    nb = T * B * V * 4 + 9 * B * W * 4 + T * B * W * 4 + 4 * 9 * B * W * 4
    b_ms, b_by = bound(nb, T * B * (2 * W * V + 30 * W * 4), F32_FLOPS)
    report["tp_scan"] = dict(
        ms=ms_by[f"{auto4} n=4"], design_n4=auto4, ms_by_design=ms_by,
        exchange_bytes=T * B * 4 * 3 * W * 16,
        plain_ms=cuda_ms(lambda: fused_decode.tp_scan_plain(lp_r, init_p, 4),
                         iters=1, warmup=0),
        library_ms=None, max_abs_err=tps_err, bound_ms=b_ms, bound_by=b_by)
    print(f"tp_scan T=200 B=256 V=47 W=100 on {card}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms_by.items()) + " (CUDA events, best "
        f"of 2 turns' means of 3); \"auto\" at n=4: {auto4}", flush=True)

    # 11c. the exchange's toy at n = 2, 4, 8 (Bt=256, T=6) in both
    # transports on the one card against the numpy oracle, every step and
    # every shard (the push transport across cards: phase 15d)
    toy_keys = {n_: np.sort(rng.integers(-1000, 1000, (n_, 6, 256, 128)),
                            axis=-1)[..., ::-1].astype(np.int32).copy()
                for n_ in (2, 4, 8)}
    zero_counts()
    toy_out = {(n_, design): exchange_probe.toy_exchange_scan(
        torch.from_numpy(k).to(dev), n_, design=design)
        for n_, k in toy_keys.items() for design in ("cluster", "push")}
    torch.cuda.synchronize()
    toy_launches = read_counts()
    check(toy_launches["toy_exchange"] == 6,
          f"toy_exchange launches {toy_launches['toy_exchange']}")
    toy_err = 0
    for (n_, design), got in toy_out.items():
        want = exchange_probe.toy_exchange_oracle(toy_keys[n_])
        got = got.cpu().numpy()
        for s_ in range(n_):
            check(np.array_equal(got[s_], want), f"toy_exchange n={n_} "
                  f"{design} shard {s_} differs from the oracle")
            toy_err = max(toy_err, int(np.abs(got[s_] - want).max()))
    print("toy_exchange n=2, 4, 8 (Bt=256, T=6), cluster and push "
          "transports == the numpy oracle on every step and shard",
          flush=True)
    k4 = torch.from_numpy(toy_keys[4]).to(dev)
    # keys in and out; the exchanged lists (tp_scan's note) stay apart
    b_ms, b_by = bound(2 * k4.numel() * 4, k4.numel() * 2 * 8 * 4, F32_FLOPS)
    toy_ms = {d: cuda_ms(lambda d=d: exchange_probe.toy_exchange_scan(
        k4, 4, design=d)) for d in ("cluster", "push")}
    report["toy_exchange"] = dict(
        exchange_bytes=k4.numel() * 16 * 3, ms=toy_ms["cluster"],
        ms_by_design=toy_ms,
        plain_ms=cuda_ms(lambda: exchange_probe.toy_exchange_scan_plain(k4,
                                                                        4),
                         iters=1, warmup=1),
        library_ms=None, max_abs_err=float(toy_err), bound_ms=b_ms,
        bound_by=b_by)
    print(f"toy_exchange n=4 (T=6, Bt=256) on {card}: cluster "
          f"{toy_ms['cluster']:.4f} ms, push {toy_ms['push']:.4f} ms (CUDA "
          f"events, mean of 10)", flush=True)

    # 11d. ctc_beam_search_tp on phase 6's log-probs with {"model": 4} on
    # cuda:0 x 4: "fused" (1 tp_scan launch), "fused_frame" (one tp_frame
    # launch a frame for the card's 4 shards and the closing merge: T + 1),
    # each equal to the single-card kernel decode; "xla" (the plain frame
    # on every shard) on the first TP_XLA_T frames
    mesh4 = tp_mesh({"model": 4})

    def tp_decode(lp_in, mesh, impl, **kw):
        return decode_tp.ctc_beam_search_tp(lp_in, beam_width=W, mesh=mesh,
                                            max_len=L, tp_impl=impl, **kw)

    for impl in ("fused", "fused_frame"):                   # warm-up
        tp_decode(lp, mesh4, impl)
    torch.cuda.synchronize()
    zero_counts()
    tp_res = {impl: tp_decode(lp, mesh4, impl)
              for impl in ("fused", "fused_frame")}
    torch.cuda.synchronize()
    tpb_launches = read_counts()
    want_tp = {name: 0 for name in counters}
    want_tp.update(tp_scan=1, tp_frame=T + 1, traceback=2)
    for name, n_ in want_tp.items():
        check(tpb_launches[name] == n_, f"TP batch launches of {name}: "
              f"{tpb_launches[name]}, expected {n_}")
    for impl, r in tp_res.items():
        same_result(r, res_k, f"ctc_beam_search_tp '{impl}' n=4")
    r_x = tp_decode(lp[:TP_XLA_T], mesh4, "xla")
    same_result(r_x, ctc_beam_search(lp[:TP_XLA_T], beam_width=W, max_len=L),
                f"ctc_beam_search_tp 'xla' n=4 T={TP_XLA_T}")
    mesh1 = tp_mesh({"model": 1})
    for impl in ("fused", "fused_frame"):
        same_result(tp_decode(lp, mesh1, impl), res_k,
                    f"ctc_beam_search_tp '{impl}' n=1")
    print(f"ctc_beam_search_tp reference_large (T=200, B=256, V=47, W=100) "
          f"'fused' and 'fused_frame' at n=4 and n=1, 'xla' at n=4 on T="
          f"{TP_XLA_T}: == the single-card decode (tokens, lengths, "
          f"timesteps, overflow, score bits); launches {tpb_launches}",
          flush=True)
    tp_ms = {f"{impl} n={n_}": host_ms(lambda: tp_decode(lp, m, impl))
             for n_, m in ((4, mesh4), (1, mesh1))
             for impl in ("fused", "fused_frame")}
    tp_ms[f"xla n=4 T={TP_XLA_T}"] = host_ms(
        lambda: tp_decode(lp[:TP_XLA_T], mesh4, "xla"))
    tp_ms["single-card ctc_beam_search"] = host_ms(
        lambda: ctc_beam_search(lp, beam_width=W, max_len=L))
    print(f"TP decode reference_large on {card} (host clock, median of 5, "
          f"synchronised; decode + traceback, no lists): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in tp_ms.items()), flush=True)
    # the "fused_frame" decode's device kernels in time order, by
    # torch.profiler in a fresh process (`tp_profile_run`: in this one,
    # after phases 9-10, the profiler recorded no kernel of the port): one
    # tp_frame launch a frame and the closing merge, nothing between
    prof = tp_profile_run(T, B, V, W, L)
    check(prof["tp_frame_launches"] == T + 1 and not prof["others"],
          f"'fused_frame' n=4 device kernels: {prof['tp_frame_launches']} "
          f"tp_frame (expected {T + 1}), others in the loop "
          f"{prof['others']}")
    report["tp_frame"].update(
        device_ms=prof["single_call_us"] / 1e3,
        loop_launch_ms=prof["loop_launch_us"] / 1e3,
        closing_merge_ms=prof["closing_merge_us"] / 1e3,
        fused_frame_n4_ms=tp_ms["fused_frame n=4"])
    print(f"'fused_frame' n=4 on {card} (torch.profiler, a fresh process, "
          f"random log-probs of the same shape): {prof['tp_frame_launches']} "
          f"tp_frame launches and no other device kernel, copy or fill "
          f"between the first and the last; a frame's launch (4 shards, "
          f"merge + frame) {prof['loop_launch_us']:.2f} us on the device, "
          f"the closing merge {prof['closing_merge_us']:.2f} us; the "
          f"JAX-shaped single call (one window of 12) "
          f"{prof['single_call_us']:.2f} us", flush=True)

    # 11e. conformer_l: phase 8's log-probs (B=64, T'=300, V=129, W=16) on
    # the preset's own mesh {"data": 2, "model": 4}, one model row
    mesh_c = tp_mesh(PRESETS["conformer_l"].mesh_shape)

    def c_tp(impl):
        return decode_tp.ctc_beam_search_tp(
            lp_c, beam_width=cfg_c.beam_width, mesh=mesh_c,
            blank_id=cfg_c.blank_id, max_len=cfg_c.decode_max_len,
            tp_impl=impl)

    for impl in ("fused", "fused_frame"):                   # warm-up
        c_tp(impl)
    torch.cuda.synchronize()
    zero_counts()
    c_res = {impl: c_tp(impl) for impl in ("fused", "fused_frame")}
    torch.cuda.synchronize()
    tpc_launches = read_counts()
    T4 = lp_c.shape[0]
    check(tpc_launches["tp_scan"] == 1 and tpc_launches["tp_frame"] == T4 + 1,
          f"conformer TP launches {tpc_launches}")
    for impl, r in c_res.items():
        same_result(r, res_c, f"conformer_l ctc_beam_search_tp '{impl}'")
    c_tp_ms = {impl: host_ms(lambda: c_tp(impl))
               for impl in ("fused", "fused_frame")}
    print(f"conformer_l decode (B=64, T'=300, V=129, W=16) on the mesh "
          f"{mesh_c.shape} (cuda:0 x 8, one model row): 'fused' and "
          f"'fused_frame' == phase 8's decode (tokens, lengths, timesteps, "
          f"overflow, score bits); launches {tpc_launches}; 'fused' "
          f"{c_tp_ms['fused']:.3f} ms, 'fused_frame' "
          f"{c_tp_ms['fused_frame']:.3f} ms (host clock, median of 5)",
          flush=True)
    del lp_c, res_c, c_res

    # 11f. streaming_step_tp over phase 6's log-probs in 10 chunks of 20
    # frames, "fused" and "fused_frame", each == 11d's batch result
    def tp_stream(impl):
        st = streaming_init(B, W, max_len=L, device=dev)
        for i in range(n_chunks):
            st, snap_ = decode_tp.streaming_step_tp(
                st, lp[i * STREAM_TC:(i + 1) * STREAM_TC], mesh=mesh4,
                tp_impl=impl)
        return snap_

    tps_launches = {name: 0 for name in counters}
    per_chunk_of = {"fused": ("tp_scan", 1),
                    "fused_frame": ("tp_frame", STREAM_TC + 1)}
    for impl, (kernel, per_chunk) in per_chunk_of.items():
        tp_stream(impl)                                      # warm-up
        torch.cuda.synchronize()
        zero_counts()
        snap_tp = tp_stream(impl)
        torch.cuda.synchronize()
        got = read_counts()
        check(got["traceback_overlay"] == n_chunks and
              got[kernel] == n_chunks * per_chunk and got["traceback"] == 0,
              f"TP stream '{impl}' launches {got}")
        same_result(snap_tp, tp_res[impl], f"TP stream '{impl}' vs TP batch")
        tps_launches = {k: v + got[k] for k, v in tps_launches.items()}
        print(f"TP stream '{impl}' ({n_chunks} x {STREAM_TC} frames, n=4) == "
              f"TP batch decode (tokens, lengths, timesteps, overflow, score "
              f"bits); launches {got}; whole stream "
              f"{host_ms(lambda: tp_stream(impl)):.3f} ms (host clock, median "
              f"of 5)", flush=True)

    # ---- 12. the shapes past the earlier kernels' limits, as JAX's
    # dispatch sends them
    # 12a. rnn_forward(impl="pallas") past the resident limit (the streamed
    # design): T=200, one direction, each (B, H) one launch; one step and
    # 200 steps against rnn_scan_plain; kernel and bf16 loop in turns
    from gasr_tpu_torch.ops.rnn import (_input_projection as rnn_proj,
                                        rnn_forward, rnn_init)
    streamed = {}
    rs_launches = {name: 0 for name in counters}
    for B_, H_ in ((8, 2816), (32, 5120), (256, 4480)):
        tag_ = f"B={B_} H={H_}"
        params_r = rnn_init(torch.Generator().manual_seed(H_), 64, H_,
                            device=dev)
        x_r = torch.from_numpy(np.random.default_rng(B_).standard_normal(
            (T, B_, 64)).astype(np.float32)).to(dev)
        design = rnn_scan.design(dev, B_, H_)
        check(design == "streamed", f"rnn_scan {tag_}: design {design}")
        with torch.no_grad():
            rnn_forward(params_r, x_r, impl="pallas")       # warm-up
            torch.cuda.synchronize()
            zero_counts()
            s0 = rnn_scan.streamed_launches
            out_r = rnn_forward(params_r, x_r, impl="pallas")
            torch.cuda.synchronize()
            got_ = read_counts()
            n_str = rnn_scan.streamed_launches - s0
            check(got_["rnn_scan"] == 1 and n_str == 1,
                  f"rnn_forward {tag_}: launches {got_}, streamed {n_str}")
            rs_launches = {k: v + got_[k] for k, v in rs_launches.items()}
            cell = params_r["layers"][0]
            xw_r = rnn_proj(cell, x_r)
            h0_r = torch.zeros(B_, H_, device=dev)
            want_r = rnn_scan.rnn_scan_plain(xw_r, cell["w_hh"], h0_r)
            check(bool(torch.isfinite(out_r).all())
                  and tuple(out_r.shape) == (T, B_, H_),
                  f"rnn_forward {tag_} output")
            e_scan = float((out_r - want_r).abs().max())
            h_r = torch.tanh(torch.from_numpy(np.random.default_rng(
                H_).standard_normal((B_, H_)).astype(np.float32)).to(dev))
            e_step = float((rnn_scan.rnn_scan(xw_r[:1], cell["w_hh"], h_r)
                            - rnn_scan.rnn_scan_plain(xw_r[:1], cell["w_hh"],
                                                      h_r)).abs().max())
        check(e_step <= RNN_STEP_TOL, f"rnn_scan {tag_}: step {e_step}")
        check(e_scan <= RNN_SCAN_TOL, f"rnn_scan {tag_}: T=200 {e_scan}")
        w_bf_r = cell["w_hh"].to(torch.bfloat16)

        def loop_r():
            h = h0_r.to(torch.bfloat16)
            for t in range(T):
                h = torch.tanh(xw_r[t] + torch.matmul(h, w_bf_r)).to(
                    torch.bfloat16)
        rounds_r = {"kernel": [], "library": []}
        for _ in range(5):
            rounds_r["kernel"].append(cuda_ms(lambda: rnn_scan.rnn_scan(
                xw_r, cell["w_hh"], h0_r), iters=1, warmup=1))
            rounds_r["library"].append(cuda_ms(loop_r, iters=1, warmup=1))
        b_ms, b_by = bound(2 * T * B_ * H_ * 4 + H_ * H_ * 4 + B_ * H_ * 4,
                           2 * T * B_ * H_ * H_, BF16_TENSOR_FLOPS)
        streamed[tag_] = dict(
            design=design, plan=list(rnn_scan._card_design(dev, B_, H_)[1]),
            ms=float(np.median(rounds_r["kernel"])),
            library_ms=float(np.median(rounds_r["library"])),
            plain_ms=cuda_ms(lambda: rnn_scan.rnn_scan_plain(
                xw_r, cell["w_hh"], h0_r), iters=1, warmup=1),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=max(e_step, e_scan),
            step_err=e_step, launches=got_["rnn_scan"],
            ms_rounds=rounds_r["kernel"],
            library_ms_rounds=rounds_r["library"])
        r = streamed[tag_]
        print(f"rnn_forward(impl='pallas') T={T} {tag_} on {card}: design "
              f"{design} (plan (Hp, MB, gB, gBr, NU, gN, WGM, WGN, WGK, S) "
              f"{r['plan']}), {got_['rnn_scan']} launch; one step max "
              f"|kernel - plain| {e_step} (tolerance {RNN_STEP_TOL}), T=200 "
              f"{e_scan} (tolerance {RNN_SCAN_TOL}); kernel {r['ms']:.4f} ms, "
              f"bf16 matmul + tanh loop {r['library_ms']:.4f} ms (medians of "
              f"5 rounds in turns: kernel "
              f"{[round(v_, 4) for v_ in rounds_r['kernel']]}, loop "
              f"{[round(v_, 4) for v_ in rounds_r['library']]}), plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del params_r, x_r, out_r, xw_r, want_r, w_bf_r
    report["rnn_scan"]["streamed"] = streamed

    # 12a, the LSTM: lstm_forward(impl="pallas") on bidirectional layers
    # past the resident limit (the streamed design), each (B, H, T) one
    # launch for both directions; one step from a random (h, c) and T steps
    # against lstm_scan_plain; the kernel and torch.nn.LSTM (cuDNN, bf16,
    # bidirectional, input 64: its time includes its small input
    # projection) in turns
    from gasr_tpu_torch.ops.lstm import (_input_projection as lstm_proj,
                                         lstm_forward, lstm_init)
    lstm_streamed = {}
    ls_launches = {name: 0 for name in counters}
    for B_, H_, T_ in ((32, 1024, 300), (8, 1536, 200), (256, 2048, 200)):
        tag_ = f"B={B_} H={H_} T={T_}"
        params_l = lstm_init(torch.Generator().manual_seed(H_), 64, H_,
                             bidirectional=True, device=dev)
        x_l = torch.from_numpy(np.random.default_rng(B_).standard_normal(
            (T_, B_, 64)).astype(np.float32)).to(dev)
        design = lstm_scan.design(dev, B_, H_, 2)
        check(design == "streamed", f"lstm_scan {tag_}: design {design}")
        cf, cb = params_l["layers"][0], params_l["layers_rev"][0]
        with torch.no_grad():
            lstm_forward(params_l, x_l, impl="pallas")       # warm-up
            torch.cuda.synchronize()
            zero_counts()
            s0 = lstm_scan.streamed_launches
            out_l = lstm_forward(params_l, x_l, impl="pallas")
            torch.cuda.synchronize()
            got_ = read_counts()
            n_str = lstm_scan.streamed_launches - s0
            check(got_["lstm_scan"] == 1 and n_str == 1,
                  f"lstm_forward {tag_}: launches {got_}, streamed {n_str}")
            ls_launches = {k: v + got_[k] for k, v in ls_launches.items()}
            xf_l, xb_l = lstm_proj(cf, x_l), lstm_proj(cb, x_l)
            z_l = torch.zeros(B_, H_, device=dev)
            want_l = torch.cat([
                lstm_scan.lstm_scan_plain(xf_l, cf["w_hh"], z_l, z_l),
                lstm_scan.lstm_scan_plain(xb_l, cb["w_hh"], z_l, z_l, True)],
                -1)
            check(bool(torch.isfinite(out_l).all())
                  and tuple(out_l.shape) == (T_, B_, 2 * H_),
                  f"lstm_forward {tag_} output")
            e_scan = float((out_l - want_l).abs().max())
            srng = np.random.default_rng(H_ + 1)
            h_l = torch.tanh(torch.from_numpy(srng.standard_normal(
                (B_, H_)).astype(np.float32))).to(dev)
            c_l = torch.from_numpy(srng.standard_normal((B_, H_)).astype(
                np.float32)).to(dev)
            step_k = lstm_scan.lstm_scan_bidir(xf_l[:1], xb_l[-1:],
                                               cf["w_hh"], cb["w_hh"], h_l,
                                               c_l)
            step_p = torch.cat([
                lstm_scan.lstm_scan_plain(xf_l[:1], cf["w_hh"], h_l, c_l),
                lstm_scan.lstm_scan_plain(xb_l[-1:], cb["w_hh"], h_l, c_l,
                                          True)], -1)
            e_step = float((step_k - step_p).abs().max())
        check(e_step <= LSTM_STEP_TOL, f"lstm_scan {tag_}: step {e_step}")
        check(e_scan <= LSTM_SCAN_TOL, f"lstm_scan {tag_}: T={T_} {e_scan}")
        nn_l = torch.nn.LSTM(64, H_, bidirectional=True).to(dev,
                                                            torch.bfloat16)
        nn_l.flatten_parameters()
        x_lb = x_l.to(torch.bfloat16)

        def kern_l():
            lstm_scan.lstm_scan_bidir(xf_l, xb_l, cf["w_hh"], cb["w_hh"],
                                      z_l, z_l)
        rounds_l = {"kernel": [], "library": []}
        with torch.no_grad():
            for _ in range(5):
                rounds_l["kernel"].append(cuda_ms(kern_l, iters=1, warmup=1))
                rounds_l["library"].append(cuda_ms(lambda: nn_l(x_lb),
                                                   iters=1, warmup=1))
            plain_ms_l = cuda_ms(lambda: (
                lstm_scan.lstm_scan_plain(xf_l, cf["w_hh"], z_l, z_l),
                lstm_scan.lstm_scan_plain(xb_l, cb["w_hh"], z_l, z_l, True)),
                iters=1, warmup=0)
        b_ms, b_by = bound(2 * T_ * B_ * 4 * H_ * 4 + T_ * B_ * 2 * H_ * 4
                           + 2 * H_ * 4 * H_ * 4 + 2 * B_ * H_ * 4,
                           2 * 2 * T_ * B_ * H_ * 4 * H_, BF16_TENSOR_FLOPS)
        lstm_streamed[tag_] = dict(
            design=design,
            plan=list(lstm_scan._card_design(dev, B_, H_, 2)[1]),
            ms=float(np.median(rounds_l["kernel"])),
            library_ms=float(np.median(rounds_l["library"])),
            plain_ms=plain_ms_l, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=max(e_step, e_scan), step_err=e_step,
            launches=got_["lstm_scan"], ms_rounds=rounds_l["kernel"],
            library_ms_rounds=rounds_l["library"])
        r = lstm_streamed[tag_]
        print(f"lstm_forward(impl='pallas') bidirectional {tag_} on {card}: "
              f"design {design} (plan (Hp, KS, MB, gB, gBr, NU, gN, WGM, "
              f"WGN, WGK, S) {r['plan']}), {got_['lstm_scan']} launch; one "
              f"step max |kernel - plain| {e_step} (tolerance "
              f"{LSTM_STEP_TOL}), T={T_} {e_scan} (tolerance "
              f"{LSTM_SCAN_TOL}); kernel {r['ms']:.4f} ms, torch.nn.LSTM "
              f"bf16 (cuDNN) {r['library_ms']:.4f} ms (medians of 5 rounds "
              f"in turns: kernel {[round(v_, 4) for v_ in rounds_l['kernel']]}"
              f", cuDNN {[round(v_, 4) for v_ in rounds_l['library']]}), "
              f"plain {plain_ms_l:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del params_l, x_l, out_l, xf_l, xb_l, want_l, nn_l, x_lb
    report["lstm_scan"]["streamed"] = lstm_streamed

    # 12b. the fused stem at F = 128, 160, 512 (f2 windows; the conv kernel's
    # shared memory is the same at every F) against its plain version, and
    # conformer_apply(stem_impl="pallas") at F = 128 on conformer_l's widths
    # (depth cut to 2 blocks)
    smem_d = _lib.load("stem").stem_conv_smem(512)
    wide = {}
    for F_, B_, T_ in ((128, 64, 1200), (160, 16, 1200), (512, 4, 1200)):
        ws_ = stem_weights(F_, 512, 512, F_)
        xs_ = torch.from_numpy(np.random.default_rng(F_).uniform(
            size=(B_, T_, F_)).astype(np.float32)).to(dev)
        n0 = stem.launches
        got_s = stem.fused_stem(xs_, *ws_)
        want_s = stem.fused_stem_plain(xs_, *ws_)
        torch.cuda.synchronize()
        check(stem.launches == n0 + 1, f"fused_stem F={F_}: launches")
        err = float((got_s.float() - want_s.float()).abs().max())
        scale = float(want_s.float().abs().max())
        tol = KERNEL_REL_TOL * max(1.0, scale)
        check(tuple(got_s.shape) == (B_, T_ // 4, 512)
              and bool(torch.isfinite(got_s).all()) and err <= tol,
              f"fused_stem F={F_}: {err} > {tol}")
        st_flops = 2 * B_ * (T_ // 2) * (F_ // 2) * 512 * 9 \
            + 2 * B_ * (T_ // 4) * (F_ // 4) * 512 * (9 * 512 + 512)
        st_bytes = xs_.numel() * 4 + sum(w.numel() * 4 for w in ws_) \
            + B_ * (T_ // 4) * 512 * 2
        b_ms, b_by = bound(st_bytes, st_flops, BF16_TENSOR_FLOPS)
        wide[f"F={F_}"] = dict(
            B=B_, T=T_, windows=stem.f2_windows(F_ // 4),
            ms=cuda_ms(lambda: stem.fused_stem(xs_, *ws_), iters=3,
                       warmup=1),
            plain_ms=cuda_ms(lambda: stem.fused_stem_plain(xs_, *ws_),
                             iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        stem_err = max(stem_err, err)
        r = wide[f"F={F_}"]
        print(f"fused_stem [{B_}, {T_}, {F_}] d=512 ({r['windows']} f2 "
              f"windows, {smem_d} bytes of shared memory a conv block at "
              f"every F) on {card}: max |kernel - plain| {err} (tolerance "
              f"{tol}); {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del ws_, xs_, got_s, want_s
    report["fused_stem"]["wide_f"] = wide
    report["fused_stem"]["max_abs_err"] = stem_err
    cfg_w = dataclasses.replace(PRESETS["conformer_l"], mesh_shape={},
                                input_size=128, num_blocks=2, batch_size=16)
    params_w = model_init(cfg_w, torch.Generator().manual_seed(1))
    x_w = torch.from_numpy(np.random.default_rng(128).uniform(
        size=(cfg_w.batch_size, cfg_w.seg_len, 128)).astype(np.float32)).to(
        dev)
    with torch.no_grad():
        model_apply(cfg_w, params_w, x_w, compute_dtype="bfloat16",
                    stem_impl="pallas")                      # warm-up
        torch.cuda.synchronize()
        zero_counts()
        lp_w = model_apply(cfg_w, params_w, x_w, compute_dtype="bfloat16",
                           stem_impl="pallas")
        torch.cuda.synchronize()
        cw_launches = read_counts()
        lp_wa = model_apply(cfg_w, params_w, x_w, compute_dtype="bfloat16")
    check(cw_launches["fused_stem"] == 1
          and cw_launches["flash_mhsa_rel"] == cfg_w.num_blocks,
          f"conformer F=128 stem_impl='pallas' launches {cw_launches}")
    check(tuple(lp_w.shape) == (cfg_w.seg_len // 4, cfg_w.batch_size,
                                cfg_w.output_size)
          and bool(torch.isfinite(lp_w).all())
          and float((lp_w.exp().sum(-1) - 1).abs().max()) < 1e-4,
          "conformer F=128 log-probs")
    print(f"conformer_apply(stem_impl='pallas') at F=128 (conformer_l "
          f"widths, 2 blocks, B={cfg_w.batch_size}, T={cfg_w.seg_len}): "
          f"launches {cw_launches}; log-probs finite and normalised; max "
          f"|lp - lp with the plain stem| {float((lp_w - lp_wa).abs().max())}"
          f" (not gated: bf16 flips)", flush=True)
    del params_w, x_w, lp_w, lp_wa

    # 12c. the traceback at conformer_l's decode shape (T=300, B=64, W=16)
    # and the LM edges' (T=200, B=256, W=64) on real decodes, and at edge
    # shapes on random backpointers, against its plain version; no memset
    # and one device kernel a call (torch.profiler)
    tb_more = {}
    for tag_, (T_, B_, V_, W_) in {"conformer_l": (300, 64, 129, 16),
                                   "LM W=64": (200, 256, 129, 64)}.items():
        lp_t = torch.from_numpy(log_softmax_np(rng.standard_normal(
            (T_, B_, V_)))).to(dev)
        fin_t, ys_t = fused_decode.fused_prefix_decode(
            lp_t, _init_beam(B_, W_, dev))
        len_t = fin_t.length
        for a, b in zip(fused_decode.traceback(ys_t, len_t, L),
                        fused_decode.traceback_plain(ys_t, len_t, L)):
            check(torch.equal(a, b), f"traceback {tag_} differs")
        nb = T_ * B_ * W_ * 4 + 2 * B_ * W_ * 4 + 2 * B_ * W_ * L * 4
        b_ms, b_by = bound(nb, T_ * B_ * W_ * 5, F32_FLOPS)
        tb_more[tag_] = dict(
            T=T_, B=B_, W=W_, L=L, plan=list(fused_decode.traceback_plan(W_)),
            ms=cuda_ms(lambda: fused_decode.traceback(ys_t, len_t, L)),
            bound_ms=b_ms, bound_by=b_by)
        print(f"traceback {tag_} (T={T_}, B={B_}, W={W_}, L={L}) on {card}: "
              f"kernel == plain; {tb_more[tag_]['ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del lp_t, fin_t, ys_t
    tb_rng = np.random.default_rng(12)
    for T_, B_, W_, L_, extra in ((200, 256, 100, 256, 300), (9, 3, 1, 6, 3),
                                  (7, 2, 128, 9, 4), (5, 2, 4, 0, 2),
                                  (0, 2, 6, 8, 3), (11, 2, 200, 7, 3)):
        ys_e = torch.from_numpy((tb_rng.integers(0, W_, (T_, B_, W_))
                                 | (tb_rng.integers(0, 47, (T_, B_, W_)) << 15)
                                 | ((tb_rng.random((T_, B_, W_)) < 0.9)
                                    .astype(np.int64) << 30)).astype(
            np.int32)).to(dev)
        len_e = torch.from_numpy(tb_rng.integers(
            0, L_ + extra + 1, (B_, W_)).astype(np.int32)).to(dev)
        for a, b in zip(fused_decode.traceback(ys_e, len_e, L_),
                        fused_decode.traceback_plain(ys_e, len_e, L_)):
            check(torch.equal(a, b), f"traceback T={T_} B={B_} W={W_} "
                  f"L={L_} (lengths up to L + {extra}) differs")
    print("traceback == plain at the edge shapes (T, B, W, L): lengths past "
          "L (200, 256, 100, 256), W = 1, W = 128, L = 0, T = 0, W = 200 (two "
          "blocks an utterance)", flush=True)
    report["traceback"]["more_shapes"] = tb_more
    print(f"traceback reference_large {report['traceback']['ms']:.4f} ms, "
          f"bound {report['traceback']['bound_ms']:.4f} ms (phase 2)",
          flush=True)

    # ---- 13. the reference harness shim (baseline_compat) as a
    # subprocess on the card, its output parsed
    compat_cfg = _lib.BUILD / "chip_smoke" / "compat.json"
    compat_cfg.parent.mkdir(parents=True, exist_ok=True)
    compat_cfg.write_text(json.dumps([
        {"batch_size": 8, "input_size": 26, "n_context": 1,
         "linear_size": 256, "rnn_hidden_size": 256, "vocab_size": 46,
         "seg_len": 50, "epoch": 2, "device": "cuda", "num_threads": 4,
         "beam_width": 10},
        {"batch_size": 3, "input_size": 10, "n_context": 0,
         "linear_size": 40, "rnn_hidden_size": 50, "vocab_size": 3,
         "seg_len": 9, "epoch": 1, "device": "cuda", "num_threads": 4,
         "beam_width": 2}]))
    p13 = subprocess.run(
        [sys.executable, "-m", "gasr_tpu_torch.baseline_compat",
         str(compat_cfg)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600)
    check(p13.returncode == 0, f"baseline_compat exited {p13.returncode}:"
          f"\n{p13.stderr[-3000:]}")
    compat_out = p13.stdout
    for pat in (r"^Forward: \d+\.\d+ s$", r"^CTC Decode \d+\.\d+ s$",
                r"^Overall \d+\.\d+ s$", r"^====== config ======$"):
        check(len(re.findall(pat, compat_out, re.M)) == 2,
              f"baseline_compat output: {pat} not twice in {compat_out}")
    print("python -m gasr_tpu_torch.baseline_compat on two configs "
          "(device cuda): the three lines each", flush=True)

    # ---- 14. training at full width (train_phase)
    torch.cuda.empty_cache()
    print(f"device memory held by the earlier phases: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    train_report, train_runs = train_phase(card, zero_counts, read_counts)
    report["flash_mhsa_rel"]["training"] = dict(
        train_report["flash_backward"], grads_bit_equal_to_recompute=True)
    report["fused_stem"]["training"] = dict(
        train_report["stem_backward"], grads_bit_equal_to_recompute=True)
    report["ctc_loss"], train_runs["ctc_loss_pair"] = ctc_phase(card)

    # ---- 15. multi-card training and the graft entries
    torch.cuda.empty_cache()
    par_report, par_runs = parallel_phase(card, zero_counts, read_counts,
                                          report)
    train_runs.update(par_runs)

    # ---- 16. parakeet_ctc_batch's kernels at its shapes
    torch.cuda.empty_cache()
    print(json.dumps({"parakeet": parakeet_phase(card)}), flush=True)

    # ---- 17. the conformer block's residual add and LayerNorm
    torch.cuda.empty_cache()
    print(json.dumps({"add_ln": add_ln_phase(card)}), flush=True)

    sources = {
        "topk": ("gasr_tpu_torch/csrc/topk.cuh",
                 "gasr_tpu/ops/pallas/topk.py:193"),
        "fused_prefix_decode": ("gasr_tpu_torch/csrc/fused_decode.cu",
                                "gasr_tpu/ops/pallas/fused_decode.py:839"),
        "traceback": ("gasr_tpu_torch/csrc/fused_decode.cu",
                      "gasr_tpu/ops/pallas/fused_decode.py:1618"),
        "traceback_overlay": ("gasr_tpu_torch/csrc/fused_decode.cu",
                              "gasr_tpu/ops/pallas/fused_decode.py:1719"),
        "rnn_scan": ("gasr_tpu_torch/csrc/rnn_scan.cu",
                     "gasr_tpu/ops/pallas/rnn_scan.py:52"),
        "flash_mhsa_rel": ("gasr_tpu_torch/csrc/flash_mhsa.cu",
                           "gasr_tpu/ops/pallas/flash_mhsa.py:308"),
        "fused_stem": ("gasr_tpu_torch/csrc/stem.cu",
                       "gasr_tpu/ops/pallas/stem.py:285"),
        "lstm_scan": ("gasr_tpu_torch/csrc/lstm_scan.cu",
                      "gasr_tpu/ops/pallas/lstm_scan.py:47"),
        "tp_frame": ("gasr_tpu_torch/csrc/decode_tp.cu",
                     "gasr_tpu/ops/pallas/fused_decode.py:1072"),
        "tp_scan": ("gasr_tpu_torch/csrc/decode_tp.cu",
                    "gasr_tpu/ops/pallas/fused_decode.py:1399"),
        "toy_exchange": ("gasr_tpu_torch/csrc/exchange_probe.cu",
                         "gasr_tpu/ops/pallas/exchange_probe.py:127"),
        # no Pallas kernel: the JAX package's loss is a lax.scan
        "ctc_loss": ("gasr_tpu_torch/csrc/ctc_loss.cu",
                     "gasr_tpu/ops/ctc_loss.py:108 (lax.scan)"),
    }
    # topk_impl="approx" adds no row and no variant: it runs rows 1-2 as
    # they are (phase 2b; its counts are the "approx_decode" paths and the
    # decode's "approx" sub-entry).
    # `launches` is each kernel's count on the path that exercises it:
    # transcribe for the first four, the stream for traceback_overlay, the
    # conformer forward + decode for flash_mhsa_rel, that path with
    # stem_impl="pallas" for fused_stem, the deepspeech2 transcribe for
    # lstm_scan, the TP batch decodes ("fused" then "fused_frame") for
    # tp_frame and tp_scan, the exchange probe of phase 11c for toy_exchange
    # (it runs on no serving path: it tests tp_scan's exchange); the
    # training runs of phase 14 are listed by path beside them
    runs = {"transcribe": launches, "streaming": s_launches,
            "approx_decode": approx_runs["no LM"],
            "approx_decode_lm": approx_runs["LM"],
            "conformer": c_launches, "conformer_stem_pallas": cs_launches,
            "deepspeech2": d_launches, "bilstm_2x256": b_launches,
            "lm_streaming": lms_launches, "transcribe_audio": a_launches,
            "transcribe_audio_cmvn": ac_launches, "evaluate_lm": ev_launches,
            "tp_batch": tpb_launches, "tp_streaming": tps_launches,
            "tp_conformer": tpc_launches, "toy_exchange": toy_launches,
            "rnn_streamed": rs_launches, "conformer_f128": cw_launches,
            "lstm_streamed": ls_launches,
            "transcribe_scan": scan_launches,
            "transcribe_streaming": ts_launches, **train_runs}
    # the LM variant's launches: those of the LM stream, per path beside
    lm_report.update(
        launches=lms_launches["fused_prefix_decode_lm"],
        launches_by_path={path: run["fused_prefix_decode_lm"]
                          for path, run in runs.items()})
    report["fused_prefix_decode"]["lm"] = lm_report
    main_path = {"traceback_overlay": "streaming",
                 "flash_mhsa_rel": "conformer",
                 "fused_stem": "conformer_stem_pallas",
                 "lstm_scan": "deepspeech2",
                 "tp_frame": "tp_batch", "tp_scan": "tp_batch",
                 "toy_exchange": "toy_exchange",
                 "ctc_loss": "train_conformer_l_bf16"}
    paths = {name: {path: run[name] for path, run in runs.items()}
             for name in sources}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        n_main = paths[name][main_path.get(name, "transcribe")]
        lib_ms = ("none" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f} ms")
        print(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib_ms}, launches by path {paths[name]}"
              + (f" (runs inside {inside[name]})" if name in inside else "")
              + f", bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max |kernel - plain| {r['max_abs_err']} "
              f"on {card}")
        if "approx" in r:
            a = r["approx"]
            print(f"kernel {name}, topk_impl='approx' (the same kernel): "
                  f"ctc_beam_search {a['ms']:.4f} ms against exact "
                  f"{a['exact_ms']:.4f}, launches {a['launches']} (with an "
                  f"LM {a['launches_lm']}), recall {a['recall']} (target "
                  f"{a['recall_target']}), kernel == plain on {card}")
        if "lm" in r:
            print(f"kernel {name}, LM variant: {r['lm']['ms']:.4f} ms (without "
                  f"the LM {r['lm']['ms_no_lm']:.4f}), plain "
                  f"{r['lm']['plain_ms']:.4f} ms, launches by path "
                  f"{r['lm']['launches_by_path']}, bound "
                  f"{r['lm']['bound_ms']:.4f} ms ({r['lm']['bound_by']}) on "
                  f"{card}")
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n_main,
            "launches_by_path": paths[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name in inside:
            entry["inside"] = inside[name]
        for extra in ("library_call", "kernel_launches_per_call", "ms_bidir",
                      "lm", "approx", "ms_by_design", "design_n4", "device_ms",
                      "loop_launch_ms", "closing_merge_ms",
                      "fused_frame_n4_ms", "ms_n2_by_cards", "ms_n4_by_cards",
                      "exchange_bytes", "ms_rounds",
                      "library_ms_rounds", "occupancy", "frame_counted",
                      "streamed", "wide_f", "more_shapes", "training",
                      "forward_ms", "backward_ms", "host_ms",
                      "plain_forward_ms", "loss_rel_err"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    # every process the phases started (nvcc, baseline_compat, the ranks)
    # has ended: none outlives the script
    card_end = card_line()
    kids = distributed.live_children()
    check(not kids, f"processes started here still run: {kids}")
    print(json.dumps({"parallel": par_report}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_end}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-profile":
        sys.exit(tp_profile_main(*json.loads(sys.argv[2])))
    if sys.argv[1:] == ["--ctc"]:
        sys.exit(ctc_main())
    if sys.argv[1:] == ["--add-ln"]:
        sys.exit(add_ln_main())
    if sys.argv[1:] == ["--parakeet"]:
        sys.exit(parakeet_main())
    sys.exit(main())
