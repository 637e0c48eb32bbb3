"""The port's training (`gasr_tpu_torch/train.py`) and the backward of its
ops against the JAX package, on numpy-seeded inputs with params carried
by params_from_jax: the autograd Functions of flash attention, the fused
stem, the mixed-dtype convolution and matmul; one train step of
deepspeech (float32) and of a two-block conformer (bf16); remat;
SpecAugment; the loop with checkpoint / resume; npz checkpoints across
frameworks; the recurrence loops' stacked outputs.

Tolerances:
  STEP_RTOL   deepspeech float32 step, loss and grad norm: the same float32
              ops; only summation orders differ.
  PARAM_ATOL  its updated params: Adam's first step moves each element by
              about lr = 3e-4 times g / (|g| + 1e-8), so a last-bit
              difference in g moves the update far less than 1e-6.
  BF16_REL    bf16 paths: a float32 summation-order difference can flip a
              bf16 rounding (2^-8 relative) and the flip travels on; the
              JAX package's own kernel-against-oracle bound, 0.02 of the
              reference's largest magnitude.
  BF16_STEP   the bf16 conformer step's loss and grad norm against JAX's
              jitted bf16 step (XLA on the CPU drops some bf16 roundings
              under jit, the port keeps them all): 5e-3, ten times
              tighter than the 5% the JAX package holds its bf16 step to
              against its float32 step (tests/test_train_extras.py).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu import train as jtrain
from gasr_tpu.models import model_apply as j_apply, model_init as j_init
from gasr_tpu.ops import conv as jconv
from gasr_tpu.ops.ctc_loss import ctc_loss as j_ctc_loss
from gasr_tpu.ops.pallas import flash_mhsa as jflash, stem as jstem
from gasr_tpu.runtime import checkpoint as jckpt

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch import train as ttrain
from gasr_tpu_torch.data.augment import spec_augment
from gasr_tpu_torch.models import model_init
from gasr_tpu_torch.ops import conv as tconv, lstm as tlstm, rnn as trnn
from gasr_tpu_torch.ops.cuda import flash_mhsa as tflash, stem as tstem
from gasr_tpu_torch.runtime import checkpoint as tckpt
from gasr_tpu_torch.runtime._tree import tensors

tlinear = sys.modules["gasr_tpu_torch.ops.linear"]

STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
BF16_REL = 0.02
BF16_STEP = 5e-3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    bound = BF16_REL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def _grads(fn, prims, g):
    """Autograd grads of fn(*prims) for the cotangent g."""
    prims = [p.detach().clone().requires_grad_() for p in prims]
    return torch.autograd.grad(fn(*prims), prims, g)


# ------------------------------------------------------- op backwards

def _flash_inputs(B, H, T, dh, seed):
    rng = np.random.default_rng(seed)
    D = H * dh
    arrs = [rng.standard_normal((B, H, T, dh)) for _ in range(3)]
    arrs += [rng.standard_normal((D, D)) * 0.2,
             rng.standard_normal((H, dh)) * 0.1,
             rng.standard_normal((H, dh)) * 0.1]
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    cot = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    return [a.astype(np.float32) for a in arrs], lens, cot


@pytest.mark.parametrize("out_f32", [False, True])
def test_flash_grads_are_the_plain_versions(out_f32):
    arrs, lens, cot = _flash_inputs(2, 2, 12, 8, 1)
    prims = [_t(a) for a in arrs]
    prims[:3] = [p.to(torch.bfloat16) for p in prims[:3]]
    ln, g = torch.from_numpy(lens), _t(cot)
    got = _grads(lambda *p: tflash.flash_mhsa_rel(*p, ln, out_f32), prims, g)
    want = _grads(lambda *p: tflash.flash_mhsa_rel_plain(*p, ln, out_f32),
                  prims, g)
    for a, b, p in zip(got, want, prims):
        assert a.dtype == p.dtype
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flash_chunked_backward_equals_unchunked(monkeypatch):
    arrs, lens, cot = _flash_inputs(4, 2, 16, 8, 2)
    prims = [_t(a) for a in arrs] + [torch.from_numpy(lens), _t(cot)]
    one = tflash.flash_mhsa_rel_vjp(*prims, out_f32=True)
    monkeypatch.setattr(tflash, "_BWD_SCORE_BYTES", 1)  # a chunk a row
    many = tflash.flash_mhsa_rel_vjp(*prims, out_f32=True)
    for a, b in zip(one[:3], many[:3]):              # per-row grads
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # wr, u, vb: each chunk's grad comes back through the bf16 casts of
    # flash_mhsa_rel_plain, so it is rounded to bf16 before the chunks
    # are summed in float32 (the JAX package's eager math; its jitted
    # CPU test sees XLA drop those roundings): equal to bf16 resolution
    for a, b in zip(one[3:], many[3:]):
        _close_bf16(b, a)


def test_flash_grads_match_jax_interpret():
    arrs, lens, cot = _flash_inputs(2, 2, 16, 8, 3)

    def j_loss(*a):
        out = jflash.flash_mhsa_rel(*a, jnp.asarray(lens), out_f32=True,
                                    interpret=True)
        return jnp.sum(out * cot)

    want = jax.grad(j_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrs))
    got = _grads(lambda *p: tflash.flash_mhsa_rel(
        *p, torch.from_numpy(lens), True), [_t(a) for a in arrs], _t(cot))
    for a, b in zip(got, want):
        _close_bf16(a, b)


def _stem_case(seed, B=2, T=16, F=8, d=128, dout=128):
    rng = np.random.default_rng(seed)
    g = lambda *shape, s: (rng.standard_normal(shape) * s).astype(  # noqa
        np.float32)
    w = [g(3, 3, 1, d, s=0.2), g(d, s=0.1), g(3, 3, d, d, s=0.05),
         g(d, s=0.1), g(F // 4 * d, dout, s=0.05), g(dout, s=0.1)]
    x = rng.uniform(size=(B, T, F)).astype(np.float32)
    cot = rng.standard_normal((B, T // 4, dout)).astype(np.float32)
    return x, w, cot


def test_stem_grads_are_the_plain_versions():
    x, w, cot = _stem_case(4)
    prims = [_t(x)] + [_t(a) for a in w]
    got = _grads(lambda *p: tstem.fused_stem(*p, out_dtype=torch.float32),
                 prims, _t(cot))
    want = _grads(lambda *p: tstem.fused_stem_plain(
        *p, out_dtype=torch.float32), prims, _t(cot))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # only what is asked for: no grad for features that need none
    ws = [p.clone().requires_grad_() for p in prims[1:]]
    out = tstem.fused_stem(prims[0], *ws, out_dtype=torch.float32)
    (out * _t(cot)).sum().backward()
    assert all(p.grad is not None for p in ws)


def test_stem_grads_match_jax_interpret():
    x, w, cot = _stem_case(5)

    def j_loss(*a):
        out = jstem.fused_stem(*a, interpret=True, out_dtype=jnp.float32)
        return jnp.sum(out * cot)

    want = jax.grad(j_loss, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in [x] + w))
    got = _grads(lambda *p: tstem.fused_stem(*p, out_dtype=torch.float32),
                 [_t(x)] + [_t(a) for a in w], _t(cot))
    for a, b in zip(got, want):
        _close_bf16(a, b)


@pytest.mark.parametrize("kind", ["depthwise_1d", "conv_2d"])
def test_conv_mixed_grads_match_jax(kind):
    rng = np.random.default_rng(6)
    if kind == "depthwise_1d":     # the conformer's conv module
        x = rng.standard_normal((2, 19, 16))
        w = rng.standard_normal((7, 1, 16)) * 0.3
        stride, groups, dn = (1,), 16, ("NWC", "WIO", "NWC")
    else:                          # a stem stage: 3x3, stride 2, SAME
        x = rng.standard_normal((2, 10, 8, 4))
        w = rng.standard_normal((3, 3, 4, 6)) * 0.3
        stride, groups, dn = (2, 2), 1, ("NHWC", "HWIO", "NHWC")
    bf = jnp.bfloat16
    xj, wj = jnp.asarray(x, bf), jnp.asarray(w, bf)
    out = jconv.conv_mixed(xj, wj, stride, "SAME", dn, groups)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jconv.conv_mixed(
        a, b, stride, "SAME", dn, groups) * cot), argnums=(0, 1))(xj, wj)
    prims = [_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)]
    got = _grads(lambda a, b: tconv.conv_mixed(a, b, stride, "SAME", groups),
                 prims, _t(cot))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        # float32 sums of the same bf16 products, rounded to bf16 once
        bound = 2.0 ** -8 * float(np.abs(_np(b)).max())
        assert float(np.abs(_np(a) - _np(b)).max()) <= bound
    # the float32 twin's VJP, as autograd gives it
    twin = _grads(lambda a, b: tconv.conv_mixed(a.float(), b.float(), stride,
                                                "SAME", groups), prims,
                  _t(cot))
    for a, b in zip(got, twin):
        torch.testing.assert_close(a, b.to(torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_tensor_core_matmul_backward(monkeypatch, batched):
    # the card's product (torch.mm(out_dtype=float32)) has no CPU kernel:
    # the CPU's float32 product of the rounded operands stands in for it,
    # and the Function's backward must equal autograd's through that
    # product (the float32 cotangent times the other operand in float32,
    # rounded to the operand's dtype)
    monkeypatch.setattr(tlinear, "_tensor_core_product",
                        lambda a, b: torch.matmul(a.float(), b.float()))
    rng = np.random.default_rng(7)
    a = _t(rng.standard_normal((3, 5, 8))).to(torch.bfloat16)
    b = _t(rng.standard_normal((3, 8, 4) if batched else (8, 4))) \
        .to(torch.bfloat16)
    g = _t(rng.standard_normal((3, 5, 4)))
    got = _grads(tlinear._TensorCoreMatmul.apply, [a, b], g)
    want = _grads(lambda x, y: torch.matmul(x.float(), y.float()), [a, b], g)
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x, y, atol=0, rtol=0)


# ------------------------------------------------------- train steps

def _ds_pair():
    kw = dict(batch_size=4, input_size=6, n_context=0, linear_size=32,
              rnn_hidden_size=32, vocab_size=10, seg_len=24)
    return jcfg.Config(**kw), tcfg.Config(**kw, device="cpu")


def _conformer_pair():
    over = dict(linear_size=32, num_blocks=2, batch_size=2, seg_len=32,
                input_size=8, vocab_size=12)
    return (dataclasses.replace(jcfg.PRESETS["conformer_s"], **over),
            dataclasses.replace(tcfg.PRESETS["conformer_s"], device="cpu",
                                **over))


def _batch(cfg, seed, S=6):
    rng = np.random.default_rng(seed)
    B, T = cfg.batch_size, cfg.seg_len
    lab_len = rng.integers(0, S + 1, B)
    lab_len[0] = S
    return {"inputs": rng.uniform(size=(B, T, cfg.feat_size)).astype(
                np.float32),
            "labels": rng.integers(1, cfg.output_size, (B, S)).astype(
                np.int32),
            "input_lengths": rng.integers(T // 2, T + 1, B).astype(np.int32),
            "label_lengths": lab_len.astype(np.int32)}


def _port_step(tc, jp, batch, mark=None, **kw):
    params = tckpt.params_from_jax(jp)
    opt = ttrain.make_optimizer()
    state = opt.init(params)
    step = ttrain.make_train_step(tc, opt, **kw)
    return step(params, state, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, mark=mark)


def test_deepspeech_step_matches_jax():
    jc, tc = _ds_pair()
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(0)))
    batch = _batch(tc, 0)
    opt = jtrain.make_optimizer()
    jp2, _, jm = jax.jit(jtrain.make_train_step(jc, opt))(
        jp, opt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, _, tm = _port_step(tc, jp, batch)
    assert set(tm) == {"loss", "grad_norm"}
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=STEP_RTOL)
    assert float(jm["grad_norm"]) > 1.0           # the clip took effect
    want = tckpt.flatten_params(jax.device_get(jp2))
    got = tckpt.flatten_params(tp2)
    moved = tckpt.flatten_params(jp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        assert np.abs(got[k] - moved[k]).max() > 1e-4, k


def test_conformer_bf16_step_matches_jax():
    """Loss and grad norm against JAX's jitted bf16 step, and every
    gradient against jax.grad of the same loss at bf16 tolerance (the
    updated params are not compared: Adam's first step takes each
    element by about lr * sign(g), so a gradient at bf16 noise level can
    take either sign in either framework)."""
    jc, tc = _conformer_pair()
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(3)))
    batch = _batch(tc, 1, S=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bf = jnp.bfloat16

    def j_loss(p):      # the JAX step's loss_fn (gasr_tpu/train.py:72-80)
        lp = j_apply(jc, p, jb["inputs"], compute_dtype=bf)
        losses = j_ctc_loss(lp, jb["labels"], jb["input_lengths"],
                            jb["label_lengths"], blank_id=jc.blank_id)
        return (losses / jnp.maximum(jb["label_lengths"].astype(
            jnp.float32), 1.0)).mean()

    loss_j, grads_j = jax.jit(jax.value_and_grad(j_loss))(jp)
    norm_j = optax.global_norm(grads_j)

    params = tckpt.params_from_jax(jp)
    leaves = [p.requires_grad_() for p in tensors(params)]
    fwd = ttrain.make_forward(tc, compute_dtype="bfloat16")
    loss_t = ttrain.batch_loss(fwd(params, torch.from_numpy(
        batch["inputs"])), {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    grads_t = dict(zip(tckpt.flatten_params(params),
                       torch.autograd.grad(loss_t, leaves)))
    for k, g in tckpt.flatten_params(jax.device_get(grads_j)).items():
        _close_bf16(grads_t[k], g)

    _, _, tm = _port_step(tc, jp, batch, compute_dtype="bfloat16")
    np.testing.assert_allclose(float(tm["loss"]), float(loss_j),
                               rtol=BF16_STEP)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(norm_j),
                               rtol=BF16_STEP)
    np.testing.assert_allclose(float(tm["loss"]), float(loss_t.detach()),
                               rtol=0)


@pytest.mark.parametrize("which", ["deepspeech", "conformer_bf16"])
def test_remat_equals_no_remat(which):
    jc, tc = _ds_pair() if which == "deepspeech" else _conformer_pair()
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(4)))
    batch = _batch(tc, 2, S=4)
    kw = {} if which == "deepspeech" else {"compute_dtype": "bfloat16"}
    p0, _, m0 = _port_step(tc, jp, batch, **kw)
    p1, _, m1 = _port_step(tc, jp, batch, remat=True, **kw)
    for k in ("loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k])
    f0, f1 = tckpt.flatten_params(p0), tckpt.flatten_params(p1)
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k])


def test_step_marks_its_phases_in_order():
    # the benchmark times the step's phases through `mark`: the phases
    # end in order, once each, and the marked step equals the unmarked one
    jc, tc = _ds_pair()
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(5)))
    batch = _batch(tc, 3, S=4)
    phases = []
    p0, _, m0 = _port_step(tc, jp, batch)
    p1, _, m1 = _port_step(tc, jp, batch, mark=phases.append)
    assert phases == ["forward", "ctc", "backward", "optimizer"]
    for k in ("loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k])
    f0, f1 = tckpt.flatten_params(p0), tckpt.flatten_params(p1)
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k])


def test_augmented_step_runs():
    _, tc = _ds_pair()
    opt = ttrain.make_optimizer()
    params = model_init(tc)
    state = opt.init(params)
    step = ttrain.make_train_step(tc, opt, augment=True)
    batch = ttrain.synthetic_batch(tc, torch.Generator().manual_seed(1),
                                   max_label_len=4)
    with pytest.raises(ValueError, match="generator"):
        step(params, state, batch)
    _, _, m = step(params, state, batch, torch.Generator().manual_seed(7))
    assert np.isfinite(float(m["loss"]))


def test_spec_augment_masks():
    x = torch.ones((3, 50, 20))
    kw = dict(num_time_masks=2, max_time_frac=0.2, num_freq_masks=2,
              max_freq=8)
    y = spec_augment(x, torch.Generator().manual_seed(0), **kw)
    assert y.shape == x.shape
    zeros = float((y == 0).float().mean())
    assert 0.0 < zeros < 0.9             # masked something, not everything
    y_again = spec_augment(x, torch.Generator().manual_seed(0), **kw)
    assert torch.equal(y, y_again)
    y2 = spec_augment(x, torch.Generator().manual_seed(1), **kw)
    assert not torch.equal(y, y2)
    for b in range(3):
        z = y[b] == 0
        rows, cols = z.all(1), z.all(0)
        # every zero lies in a masked frame or a masked bin, and the masks
        # are at most 2 runs of 10 frames and 2 runs of 8 bins
        assert bool((z == (rows[:, None] | cols[None, :])).all())
        assert int(rows.sum()) <= 2 * 10 and int(cols.sum()) <= 2 * 8
    # the JAX package's defaults: 2 masks of at most 5% of T, 2 of 10 bins
    y3 = spec_augment(torch.ones((64, 200, 80)),
                      torch.Generator().manual_seed(2))
    z = y3 == 0
    assert int(z.all(2).sum(1).max()) <= 2 * 10
    assert int(z.all(1).sum(1).max()) <= 2 * 10 and bool(z.any())


# ------------------------------------------------------- loop, checkpoints

def _tiny_cfg():
    return tcfg.Config(batch_size=4, input_size=6, n_context=0,
                       linear_size=32, rnn_hidden_size=32, vocab_size=10,
                       seg_len=24, device="cpu")


def test_train_loss_decreases():
    _, losses = ttrain.train_loop(_tiny_cfg(), num_steps=12, log_every=3)
    assert len(losses) >= 3
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_checkpoint_resume(tmp_path):
    cfg = _tiny_cfg()
    ck = str(tmp_path / "ck.npz")
    p1, _ = ttrain.train_loop(cfg, num_steps=4, checkpoint_path=ck)
    assert os.path.exists(ck)
    p2, _ = ttrain.train_loop(cfg, num_steps=2, checkpoint_path=ck,
                              resume=True)
    f1, f2 = tckpt.flatten_params(p1), tckpt.flatten_params(p2)
    assert max(float(np.abs(f1[k] - f2[k]).max()) for k in f1) > 0
    like = {"params": model_init(cfg),
            "step": torch.zeros((), dtype=torch.int32)}
    blob = tckpt.load_params(ck, like)
    assert int(blob["step"]) == 6
    for k, v in tckpt.flatten_params(blob["params"]).items():
        np.testing.assert_array_equal(v, f2[k])


def test_npz_checkpoints_cross_frameworks(tmp_path):
    jc, tc = _conformer_pair()
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(8)))
    blob_j = {"params": jp, "step": jnp.asarray(17, jnp.int32)}
    like_t = {"params": model_init(tc),
              "step": torch.zeros((), dtype=torch.int32)}
    # JAX writes, the port reads
    jckpt.save_params(str(tmp_path / "j.npz"), blob_j)
    got = tckpt.load_params(str(tmp_path / "j.npz"), like_t)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 17
    want = tckpt.flatten_params(jp)
    flat = tckpt.flatten_params(got["params"])
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    # the port writes, JAX reads
    tp = tckpt.params_from_jax(jp)
    tckpt.save_params(str(tmp_path / "t.npz"),
                      {"params": tp, "step": torch.tensor(
                          5, dtype=torch.int32)})
    back = jckpt.load_params(str(tmp_path / "t.npz"),
                             {"params": jp, "step": jnp.zeros((), jnp.int32)})
    assert int(back["step"]) == 5
    for k, v in tckpt.flatten_params(jax.device_get(back["params"])).items():
        np.testing.assert_array_equal(v, want[k])


def test_synthetic_batch_schema():
    _, tc = _ds_pair()
    b = ttrain.synthetic_batch(tc, torch.Generator().manual_seed(0))
    assert b["inputs"].shape == (4, 24, tc.feat_size)
    assert b["labels"].shape == (4, 20) and b["labels"].dtype == torch.int32
    assert int(b["labels"].min()) >= 1
    assert int(b["labels"].max()) < tc.output_size
    assert bool((b["input_lengths"] == 24).all())
    assert bool(((b["label_lengths"] >= 10) & (b["label_lengths"] <= 20))
                .all())


# ------------------------------------------------------- recurrence loops

def _loop_reference(step, xw, state, reverse):
    """The loops' earlier form: each step written into a preallocated
    output."""
    T = xw.shape[0]
    out = None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        state = step(xw[t], state)
        h = state[0] if isinstance(state, tuple) else state
        if out is None:
            out = xw.new_empty((T,) + h.shape)
        out[t] = h
    return out


@pytest.mark.parametrize("family", ["rnn", "lstm"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_recurrence_loops_stack_their_steps(family, bidirectional):
    """The loops collect their steps and stack them (a preallocated output
    is a CopySlices under autograd): the no-grad output is bit-equal to
    the earlier writes, the output under grad to the no-grad one, and the
    gradient flows to every weight."""
    mod = trnn if family == "rnn" else tlstm
    init = trnn.rnn_init if family == "rnn" else tlstm.lstm_init
    fwd = trnn.rnn_forward if family == "rnn" else tlstm.lstm_forward
    params = init(torch.Generator().manual_seed(1), 6, 8, 2, bidirectional)
    x = torch.rand((7, 3, 6), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = fwd(params, x)
        cell = params["layers"][0]
        xw = mod._input_projection(cell, x)
        zeros = torch.zeros(3, 8)
        if family == "rnn":
            step = lambda xt, h: torch.tanh(                 # noqa: E731
                xt + torch.matmul(h, cell["w_hh"]))
            ref = _loop_reference(step, xw, zeros, False)
            first = mod._scan_one_direction(cell, x, zeros)
        else:
            step = lambda xt, s: tlstm._step(                # noqa: E731
                xt, s[0], s[1], cell["w_hh"])
            ref = _loop_reference(step, xw, (zeros, zeros), False)
            first = mod._scan_one_direction(cell, x, zeros, zeros, False)
        assert torch.equal(first, ref)
        if family == "rnn":                # a reverse direction too
            rev = params.get("layers_rev", params["layers"])[0]
            xr = mod._input_projection(rev, x)
            ref_r = _loop_reference(lambda xt, h: torch.tanh(
                xt + torch.matmul(h, rev["w_hh"])), xr, zeros, True)
            assert torch.equal(mod._scan_one_direction(
                rev, x, zeros, reverse=True), ref_r)
    leaves = [p.requires_grad_() for p in tensors(params)]
    out = fwd(params, x)
    assert torch.equal(out.detach(), got)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    assert all(float(g.abs().max()) > 0 for g in grads)
