"""PyTorch port's Conformer path (conv stem, rel-pos attention, conv
module, the flash attention and fused stem kernels' plain versions, the
model, its dispatch rules, params bridge and decode) against the JAX
package, on numpy-seeded inputs with params carried by params_from_jax.

Tolerances:
  F32_TOL      float32 ops: only the summation order differs.
  F32_MODEL    the float32 model, a few blocks deep.
  STEM_FLIP    the stem at bf16 against stem_ref: see its test.
  BF16_REL     bf16 paths: a float32 summation-order difference can flip a
               bf16 rounding (2^-8 relative) and the flip travels on; the
               bound, 0.02 * max(1, max|ref|), is the JAX package's own
               kernel-against-oracle bound (tests/test_flash_mhsa.py,
               tests/test_stem.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.infer import Pipeline as JPipeline
from gasr_tpu.models import conformer as jconf
from gasr_tpu.models import model_apply as j_apply, model_init as j_init
from gasr_tpu.ops import attention as jatt, conv as jconv
from gasr_tpu.ops.pallas import flash_mhsa as jflash, stem as jstem
from gasr_tpu.runtime.checkpoint import save_params as j_save_params

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.infer import Pipeline
from gasr_tpu_torch.models import conformer as tconf
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.ops import attention as tatt, conv as tconv
from gasr_tpu_torch.ops.cuda import flash_mhsa as tflash, stem as tstem
from gasr_tpu_torch.runtime.checkpoint import flatten_params, params_from_jax

F32_TOL = 1e-5
F32_MODEL = 1e-4
BF16_REL = 0.02
STEM_FLIP = 1e-3


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_bf16(got, want, rows=None):
    got, want = _np(got), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    bound = BF16_REL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def _pair(d, blocks=2, **over):
    """conformer_s preset cut to width d and `blocks` blocks."""
    over = dict(dict(linear_size=d, num_blocks=blocks, batch_size=2,
                     seg_len=16, input_size=8, vocab_size=12), **over)
    jc = dataclasses.replace(jcfg.PRESETS["conformer_s"], **over)
    tc = dataclasses.replace(tcfg.PRESETS["conformer_s"], device="cpu",
                             **over)
    return jc, tc


def _feats(cfg, seed):
    return np.random.default_rng(seed).uniform(
        size=(cfg.batch_size, cfg.seg_len, cfg.feat_size)).astype(np.float32)


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("n,d", [(1, 4), (5, 8), (12, 72)])
def test_sinusoid_pos_matches_jax(n, d):
    want = np.asarray(jatt._sinusoid_pos(n, d))
    got = tatt._sinusoid_pos(n, d)
    assert got.shape == (2 * n - 1, d)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("T", [1, 4, 7])
def test_rel_shift_matches_jax(T):
    x = np.random.default_rng(T).standard_normal(
        (2, 3, T, 2 * T - 1)).astype(np.float32)
    want = np.asarray(jatt._rel_shift(jnp.asarray(x)))
    np.testing.assert_array_equal(tatt._rel_shift(_t(x)).numpy(), want)


@pytest.mark.parametrize("T,F", [(8, 6), (9, 7), (10, 5), (3, 4)])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_conv2d_matches_jax(T, F, cd):
    # lax "SAME" at stride 2: (0, 1) padding on even sizes, (1, 1) on odd
    C, O = 3, 5
    jp = jax.device_get(jconv.conv2d_init(jax.random.PRNGKey(T * F), C, O,
                                          (3, 3)))
    x = np.random.default_rng(F).standard_normal((2, T, F, C)).astype(
        np.float32) * 30
    want = jconv.conv2d(jp, jnp.asarray(x), (2, 2),
                        compute_dtype=None if cd is None
                        else getattr(jnp, cd))
    got = tconv.conv2d(params_from_jax(jp), _t(x), (2, 2),
                       compute_dtype=None if cd is None
                       else getattr(torch, cd))
    assert tuple(got.shape) == want.shape
    assert got.dtype == (torch.float32 if cd is None else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=0)
    assert (_np(got) == 20.0).any() and (_np(got) == 0.0).any()


def test_same_pads_match_lax():
    from jax import lax
    for n in range(1, 12):
        for k in (1, 2, 3, 31):
            for s in (1, 2, 3):
                want = lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
                assert tconv.same_pads(n, k, s) == tuple(want), (n, k, s)


def _block_params(d, heads, seed=0):
    jp = jax.device_get(jconf._block_init(jax.random.PRNGKey(seed), d, heads,
                                          4, 31))
    # nonzero attention biases, so the u / v terms are exercised
    rng = np.random.default_rng(seed + 5)
    dh = d // heads
    for name in ("u", "v"):
        jp["mhsa"][name] = (rng.standard_normal((heads, dh)) * 0.1).astype(
            np.float32)
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_conv_module_matches_jax(cd):
    T, B, D = 11, 2, 32
    jp, tp = _block_params(D, 4, 1)
    x = np.random.default_rng(2).standard_normal((T, B, D)).astype(
        np.float32)
    jcd = None if cd is None else jnp.bfloat16
    tcd = None if cd is None else torch.bfloat16
    xj = jnp.asarray(x) if cd is None else jnp.asarray(x).astype(jcd)
    xt = _t(x) if cd is None else _t(x).to(tcd)
    want = jconf._convmod(jp["conv"], xj, 31, jcd)
    got = tconf._convmod(tp["conv"], xt, 31, tcd)
    if cd is None:
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=0)
    else:
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want)


@pytest.mark.parametrize("T,B,D,H", [(9, 2, 32, 4), (13, 3, 72, 2)])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("masking", ["none", "mask", "lengths"])
def test_mhsa_rel_xla_matches_jax(T, B, D, H, cd, masking):
    jp, tp = _block_params(D, H, T)
    x = np.random.default_rng(D).standard_normal((T, B, D)).astype(
        np.float32)
    lens = np.array([T, T - 4, 1][:B], np.int32)
    mask = np.arange(T)[None, :] < lens[:, None]
    kw_j, kw_t = {}, {}
    if masking == "mask":
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    elif masking == "lengths":
        kw_j["lengths"] = jnp.asarray(lens)
        kw_t["lengths"] = torch.from_numpy(lens)
    want = jatt.mhsa_rel(jp["mhsa"], jnp.asarray(x), H, impl="xla",
                         compute_dtype=None if cd is None else jnp.bfloat16,
                         **kw_j)
    got = tatt.mhsa_rel(tp["mhsa"], _t(x), H, impl="xla",
                        compute_dtype=None if cd is None else torch.bfloat16,
                        **kw_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, B, D)
    if cd is None:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL,
                                   rtol=0)
    else:
        _close_bf16(got, want)


# ------------------------------------------------- kernels' plain versions

def _flash_inputs(B, H, T, dh, seed, ragged):
    rng = np.random.default_rng(seed)
    D = H * dh
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
               for _ in range(3))
    wr = (rng.standard_normal((D, D)) * 0.2).astype(np.float32)
    u = (rng.standard_normal((H, dh)) * 0.1).astype(np.float32)
    vb = (rng.standard_normal((H, dh)) * 0.1).astype(np.float32)
    lens = (rng.integers(1, T + 1, B) if ragged
            else np.full(B, T)).astype(np.int32)
    lens[0] = T
    return q, k, v, wr, u, vb, lens


@pytest.mark.parametrize("B,H,T,dh,ragged", [
    (2, 4, 24, 16, False),
    (3, 4, 30, 36, True),          # conformer_s's dh; D/2 = 72
    (2, 2, 2, 8, True),            # the shortest eligible T
    (2, 3, 17, 10, True),          # D/2 = 15, not a multiple of 16
])
@pytest.mark.parametrize("out_f32", [False, True])
def test_flash_plain_matches_flash_ref(B, H, T, dh, ragged, out_f32):
    ins = _flash_inputs(B, H, T, dh, T * dh, ragged)
    want = jflash.flash_ref(*(jnp.asarray(a) for a in ins), out_f32=out_f32)
    got = tflash.flash_mhsa_rel_plain(*(torch.from_numpy(a) for a in ins),
                                      out_f32=out_f32)
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    assert tuple(got.shape) == (B, H, T, dh)
    # the same factorized math on the same rounded operands: float32
    # summation order is all that differs, up to a rare bf16 flip of A, B
    # or the attention (one bf16 ulp of the output scale)
    bound = 2.0 ** -7 * max(1.0, float(np.abs(_np(want)).max()))
    assert float(np.abs(_np(got) - _np(want)).max()) <= bound
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(
        tflash.flash_mhsa_rel(*(torch.from_numpy(a) for a in ins),
                              out_f32=out_f32), got, atol=0, rtol=0)


@pytest.mark.parametrize("B,H,T,dh", [(2, 4, 20, 16), (2, 2, 12, 36)])
def test_flash_plain_matches_pallas_interpret(B, H, T, dh):
    ins = _flash_inputs(B, H, T, dh, 100 + T, ragged=True)
    want = jflash.flash_mhsa_rel(*(jnp.asarray(a) for a in ins),
                                 out_f32=True, interpret=True)
    got = tflash.flash_mhsa_rel_plain(*(torch.from_numpy(a) for a in ins),
                                      out_f32=True)
    lens = ins[-1]
    for b in range(B):
        _close_bf16(got[b, :, :lens[b]], want[b, :, :lens[b]])


def test_flash_zero_length_is_flash_ref():
    # lengths = 0 masks every key: the port (kernel and plain) averages v
    # over the T keys, as flash_ref does
    ins = list(_flash_inputs(2, 2, 6, 8, 7, ragged=False))
    ins[-1] = np.array([0, 3], np.int32)
    want = jflash.flash_ref(*(jnp.asarray(a) for a in ins), out_f32=True)
    got = tflash.flash_mhsa_rel_plain(*(torch.from_numpy(a) for a in ins),
                                      out_f32=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        ins[2][0].mean(1, keepdims=True), (2, 6, 8)), atol=0.02)


def _stem_weights(F, d, dout, seed):
    rng = np.random.default_rng(seed)
    g = lambda *shape, s: (rng.standard_normal(shape) * s).astype(  # noqa
        np.float32)
    return (g(3, 3, 1, d, s=0.2), g(d, s=0.1), g(3, 3, d, d, s=0.05),
            g(d, s=0.1), g(F // 4 * d, dout, s=0.05), g(dout, s=0.1))


@pytest.mark.parametrize("B,T,F,d,dout", [(2, 16, 8, 128, 128),
                                          (1, 24, 12, 128, 256)])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_fused_stem_plain_matches_stem_ref(B, T, F, d, dout, out):
    w = _stem_weights(F, d, dout, T + F)
    x = np.random.default_rng(T).uniform(size=(B, T, F)).astype(np.float32)
    want = jstem.stem_ref(jnp.asarray(x), *(jnp.asarray(a) for a in w),
                          out_dtype=getattr(jnp, out))
    got = tstem.fused_stem_plain(_t(x), *(_t(a) for a in w),
                                 out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    assert tuple(got.shape) == (B, T // 4, dout)
    # stem_ref's math on the same rounded operands: a float32 summation-
    # order difference can flip the bf16 rounding of a conv2 output (one
    # ulp, at most 2^-8 * 20), which reaches the output times one wp entry
    # (and a bf16 output, one ulp of its own)
    scale = max(1.0, float(np.abs(_np(want)).max()))
    tol = STEM_FLIP if out == "float32" else 2.0 ** -8 * scale
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    torch.testing.assert_close(
        tstem.fused_stem(_t(x), *(_t(a) for a in w),
                         out_dtype=getattr(torch, out)), got, atol=0, rtol=0)


def test_fused_stem_plain_matches_pallas_interpret():
    # the JAX kernel rounds b2 to bf16 where stem_ref (and the port) add it
    # in float32: within the bf16 bound
    B, T, F, d, dout = 2, 16, 8, 128, 128
    w = _stem_weights(F, d, dout, 3)
    x = np.random.default_rng(4).uniform(size=(B, T, F)).astype(np.float32)
    want = jstem.fused_stem(jnp.asarray(x), *(jnp.asarray(a) for a in w),
                            interpret=True, out_dtype=jnp.float32)
    got = tstem.fused_stem_plain(_t(x), *(_t(a) for a in w),
                                 out_dtype=torch.float32)
    _close_bf16(got, want)


def test_wrappers_refuse_inputs_that_require_grad():
    # the three custom_vjp ops no longer refuse: inputs that require grad
    # get grads (tests/test_torch_train.py holds them to the plain
    # versions and to JAX); the recurrence kernels still refuse
    # (tests/test_torch_cuda.py::test_recurrence_kernels_raise_under_autograd)
    ins = [torch.from_numpy(a) for a in _flash_inputs(1, 2, 4, 8, 0, False)]
    ins[0].requires_grad_(True)
    out = tflash.flash_mhsa_rel(*ins)
    assert out.requires_grad
    out.float().sum().backward()
    assert ins[0].grad is not None and ins[0].grad.shape == ins[0].shape
    w = [_t(a) for a in _stem_weights(8, 128, 128, 0)]
    w[2].requires_grad_(True)
    tstem.fused_stem(torch.zeros(1, 8, 8), *w).float().sum().backward()
    assert w[2].grad is not None
    wc = w[2].detach()[:, :, :1].clone().requires_grad_(True)
    tconv.conv_mixed(torch.zeros(1, 4, 4, 1), wc, (1, 1)).sum().backward()
    assert wc.grad is not None and wc.grad.shape == wc.shape


# ------------------------------------------------------------------ model

def _j_apply_f32(jc, jp, x):
    """JAX's float32 forward, jitted (one compile instead of one per op)."""
    return jax.jit(lambda p, xx: j_apply(jc, p, xx))(jp, jnp.asarray(x))


@pytest.mark.parametrize("d,T,F", [(32, 16, 12), (72, 18, 10), (128, 16, 8)])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_conformer_apply_matches_jax(d, T, F, cd):
    jc, tc = _pair(d, seg_len=T, input_size=F)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(d)))
    x = _feats(tc, d + T)
    if cd is None:
        want = _j_apply_f32(jc, jp, x)
    else:       # eager: under jit XLA on the CPU drops some bf16 roundings
        want = j_apply(jc, jp, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    got = model_apply(tc, params_from_jax(jp), torch.from_numpy(x),
                      compute_dtype=cd)
    T4 = tconf.conformer_output_length(T)
    assert tuple(got.shape) == (T4, tc.batch_size, tc.output_size)
    if cd is None:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_MODEL,
                                   rtol=0)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_conformer_pallas_impls_match_jax(cd):
    # stem_impl and attn_impl "pallas": JAX runs its kernels in interpret
    # mode, the port their plain versions. The port's stem follows
    # stem_ref (b2 in float32) where the JAX kernel rounds b2 to bf16.
    jc, tc = _pair(128, blocks=1)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(5)))
    x = _feats(tc, 6)
    kw = dict(stem_impl="pallas", attn_impl="pallas")
    want = j_apply(jc, jp, jnp.asarray(x),
                   compute_dtype=None if cd is None else jnp.bfloat16, **kw)
    got = model_apply(tc, params_from_jax(jp), torch.from_numpy(x),
                      compute_dtype=cd, **kw)
    _close_bf16(got, want)
    if cd == "bfloat16":
        # on the CPU the port's pallas stem is stem_ref, the xla stem at
        # bf16, exactly
        ref = model_apply(tc, params_from_jax(jp), torch.from_numpy(x),
                          compute_dtype=cd, attn_impl="pallas")
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("family", ["conformer_s", "conformer_l",
                                    "conformer"])
def test_conformer_families_dispatch(family):
    # every conformer name reaches conformer_init / conformer_apply, on
    # the CPU only when asked; the presets' own width, cut to one block
    cfg = dataclasses.replace(tcfg.PRESETS["conformer_s"], model=family,
                              linear_size=0, num_blocks=1, input_size=8,
                              batch_size=2, seg_len=12, device="cpu")
    params = model_init(cfg, torch.Generator().manual_seed(0))
    d = tconf._PRESETS.get(family, tconf._PRESETS["conformer_s"])["d_model"]
    assert tuple(params["sub1"]["w"].shape) == (3, 3, 1, d)
    lp = model_apply(cfg, params, torch.from_numpy(_feats(cfg, 0)))
    assert tuple(lp.shape) == (3, 2, cfg.output_size)
    assert torch.isfinite(lp).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            model_init(dataclasses.replace(cfg, device="cuda"))


def test_conformer_init_layout_matches_jax():
    jc, tc = _pair(72, blocks=3)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(0)))
    tp = model_init(tc, torch.Generator().manual_seed(0))
    flat_j, flat_t = flatten_params(jp), flatten_params(tp)
    assert sorted(flat_j) == sorted(flat_t)
    for key in flat_j:
        assert flat_t[key].shape == flat_j[key].shape, key
        assert flat_t[key].dtype == np.float32
    # zero biases and unit LayerNorm gains, as in the JAX package
    for key in ("blocks/0/mhsa/u", "blocks/2/conv/dw_b", "blocks/1/ln_out/b"):
        assert not flat_t[key].any()
    assert (flat_t["blocks/0/ff1/ln/g"] == 1).all()


@pytest.mark.parametrize("form", ["pytree", "npz"])
def test_conformer_params_round_trip(form, tmp_path):
    jc, _ = _pair(72, blocks=2)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(1)))
    if form == "pytree":
        tp = params_from_jax(jp)
    else:
        path = str(tmp_path / "conformer.npz")
        j_save_params(path, jp)
        with np.load(path) as data:
            tp = params_from_jax(data)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert tuple(tp["blocks"][1]["conv"]["dw"].shape) == (31, 1, 72)
    assert tuple(tp["sub2"]["w"].shape) == (3, 3, 72, 72)       # HWIO
    assert tuple(tp["blocks"][0]["mhsa"]["u"].shape) == (4, 18)  # [H, dh]
    flat_j, flat_t = flatten_params(jp), flatten_params(tp)
    assert sorted(flat_j) == sorted(flat_t)
    for key in flat_j:
        np.testing.assert_array_equal(flat_t[key], flat_j[key])


def test_conformer_decode_matches_jax_matched():
    # conformer_l's decode shape in small: W=16, V=129
    jc, tc = _pair(32, batch_size=3, seg_len=40, vocab_size=128)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(2)))
    x = _feats(tc, 3)
    lp_j = _j_apply_f32(jc, jp, x)
    lp_t = model_apply(tc, params_from_jax(jp), torch.from_numpy(x))
    np.testing.assert_allclose(lp_t.numpy(), _np(lp_j), atol=F32_MODEL,
                               rtol=0)
    lp = np.array(lp_j)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=16, max_len=32,
                               merge_impl="matched")
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=16,
                              max_len=32)
    for f in ("tokens", "lengths", "timesteps", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    assert (got.lengths.numpy() > 0).all()


def test_pipeline_conformer_matches_jax():
    # Pipeline passes no compute_dtype: the conformer runs in float32, as
    # the JAX Pipeline runs it
    jc, tc = _pair(32, batch_size=2, seg_len=24, vocab_size=28,
                   beam_width=8, decode_max_len=16)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(3)))
    x = _feats(tc, 4)
    want = JPipeline(jc, params=jp).transcribe(jnp.asarray(x))
    got = Pipeline(tc, params=params_from_jax(jp)).transcribe(x)
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------- dispatch rules

def test_eligibility_rules_match_jax():
    for T in (1, 2, 3, 300, 1024, 1025):
        for dh in (8, 36, 64, 128, 129):
            for D in (dh * 3, dh * 4, dh * 3 + 1):
                assert tflash.flash_eligible(T, dh, D) == \
                    jflash.flash_eligible(T, dh, D), (T, dh, D)
    for T in (4, 8, 12, 1200, 1202):
        for F in (4, 8, 80, 82):
            for d in (128, 144, 512, 1024, 1152):
                for dout in (128, 130, 512):
                    assert tstem.stem_eligible(T, F, d, dout) == \
                        jstem.stem_eligible(T, F, d, dout), (T, F, d, dout)


class _Took(Exception):
    pass


def _jax_attention_route(monkeypatch, impl, T, H, dh, has_mask, cd,
                         backend):
    """Which route JAX's mhsa_rel takes: its kernel or the rel-shift."""
    def kernel(*a, **k):
        raise _Took("kernel")

    def shift(*a, **k):
        raise _Took("xla")
    monkeypatch.setattr(jflash, "flash_mhsa_rel", kernel)
    monkeypatch.setattr(jatt, "_sinusoid_pos", shift)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    D = H * dh
    p = {n: jnp.zeros((D, D)) for n in ("wq", "wk", "wv", "wo", "wr")}
    p["u"] = p["v"] = jnp.zeros((H, dh))
    mask = jnp.ones((1, T), bool) if has_mask else None
    with pytest.raises(_Took) as took:
        jatt.mhsa_rel(p, jnp.zeros((T, 1, D)), H, mask, compute_dtype=cd,
                      impl=impl)
    return str(took.value)


@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
def test_attention_dispatch_matches_jax(monkeypatch, impl):
    # a grid of shapes (eligible, T out of range, dh > 128), boolean mask
    # or none, compute dtypes, and the accelerator (a TPU for JAX, a CUDA
    # tensor for the port) or not
    cds = ((None, None), (jnp.bfloat16, torch.bfloat16),
           (jnp.float16, torch.float16))
    if impl != "auto":          # only "auto" reads the compute dtype
        cds = cds[:2]
    for T, H, dh in ((2, 2, 4), (40, 3, 5), (1025, 1, 4), (12, 1, 130)):
        for has_mask in (False, True):
            for jcd, tcd in cds:
                for backend, on_cuda in (("cpu", False), ("tpu", True)):
                    want = _jax_attention_route(monkeypatch, impl, T, H, dh,
                                                has_mask, jcd, backend)
                    got = tatt.use_flash_kernel(impl, T, dh, H * dh,
                                                has_mask, tcd, on_cuda)
                    assert got == (want == "kernel"), (T, H, dh, has_mask,
                                                       jcd, backend)


def test_port_attention_follows_its_rule(monkeypatch):
    # on CPU tensors: "pallas" reaches the kernel's wrapper (which runs the
    # plain version), "auto" never does
    seen = []

    def record(*a, **k):
        seen.append("kernel")
        raise _Took("kernel")
    monkeypatch.setattr(tatt, "flash_mhsa_rel", record)
    p = {n: torch.zeros(8, 8) for n in ("wq", "wk", "wv", "wo", "wr")}
    p["u"] = p["v"] = torch.zeros(2, 4)
    x = torch.zeros(5, 1, 8)
    with pytest.raises(_Took):
        tatt.mhsa_rel(p, x, 2, impl="pallas")
    for impl in ("auto", "xla"):
        tatt.mhsa_rel(p, x, 2, impl=impl, compute_dtype=torch.bfloat16)
    tatt.mhsa_rel(p, x, 2, torch.ones(1, 5, dtype=torch.bool),
                  impl="pallas")
    assert seen == ["kernel"]
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.mhsa_rel(p, x, 2, impl="flash")


@pytest.mark.parametrize("stem_impl", ["xla", "pallas", "auto"])
def test_stem_dispatch_matches_jax(monkeypatch, stem_impl):
    def kernel(*a, **k):
        raise _Took("kernel")

    def conv(*a, **k):
        raise _Took("xla")
    monkeypatch.setattr(jstem, "fused_stem", kernel)
    monkeypatch.setattr(jconf, "conv2d", conv)
    monkeypatch.setattr(tconf, "fused_stem", kernel)
    monkeypatch.setattr(tconf, "conv2d", conv)
    dummy = {n: {"w": 0, "b": 0} for n in ("sub1", "sub2", "sub_proj")}
    for T, F in ((16, 8), (18, 8), (16, 10), (4, 8), (16, 4)):
        for d in (128, 144, 256):
            jc, tc = _pair(d, seg_len=T, input_size=F)
            routes = []
            for apply, xs in ((jconf.conformer_apply, jnp.zeros((1, T, F))),
                              (tconf.conformer_apply, torch.zeros(1, T, F))):
                with pytest.raises(_Took) as took:
                    apply(jc if apply is jconf.conformer_apply else tc,
                          dummy, xs, stem_impl=stem_impl)
                routes.append(str(took.value))
            assert routes[0] == routes[1], (T, F, d)
            assert routes[1] == ("kernel" if stem_impl == "pallas" and
                                 tstem.stem_eligible(T, F, d, d) else "xla")
