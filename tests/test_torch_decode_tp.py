"""PyTorch port's vocab-sharded (tensor-parallel) decode against the JAX
package: meshes, the local frame's plain version against JAX's
`fused_tp_frame` (interpret mode), `ctc_beam_search_tp` with every
`tp_impl`, `streaming_step_tp`, the exchange protocol's toy, and a small
conformer into the TP decode.

JAX gets the 8 virtual CPU devices of tests/conftest.py; the port a mesh
that repeats the CPU device (`parallel/mesh.py`). Inputs are made with
numpy from a seed and handed to both packages. Tokens, lengths and
timesteps must be equal; scores agree with JAX to 1e-5 (torch against
XLA exp/log1p on the CPU, ROADMAP "held against the reference") and are
bit-equal to the port's own single-device decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gasr_tpu import config as jcfg
from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.models import model_apply as j_apply, model_init as j_init
from gasr_tpu.ops.pallas import exchange_probe as jxp
from gasr_tpu.ops.pallas import fused_decode as jfd
from gasr_tpu.parallel import decode_tp as jtp
from gasr_tpu.parallel import mesh as jmesh

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.models import model_apply
from gasr_tpu_torch.ops.cuda import exchange_probe as txp
from gasr_tpu_torch.ops.cuda import fused_decode as tfd
from gasr_tpu_torch.parallel import decode_tp as ttp
from gasr_tpu_torch.parallel import mesh as tmesh
from gasr_tpu_torch.runtime.checkpoint import params_from_jax

SCORE_TOL = 1e-5
CPU8 = [torch.device("cpu")] * 8
IMPLS = ("xla", "fused_frame", "fused")


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _lp(seed, T, B, V):
    return _log_softmax(np.random.default_rng(seed).standard_normal(
        (T, B, V)).astype(np.float32))


def _bits_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "scores":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def _matches_jax(got, want, fields=("tokens", "lengths", "timesteps")):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


# ------------------------------------------------------------------ meshes

@pytest.mark.parametrize("shape", [None, {"model": 4}, {"data": 2,
                                                        "model": -1},
                                   {"data": 2, "model": 4}, {"model": 1}])
def test_make_mesh_matches_jax(shape):
    jm = jmesh.make_mesh(shape)
    tm = tmesh.make_mesh(shape, devices=CPU8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape


def test_make_mesh_errors_and_repeated_devices():
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh({"data": 4, "model": 4})
    with pytest.raises(ValueError) as te:
        tmesh.make_mesh({"data": 4, "model": 4}, devices=CPU8)
    assert str(te.value) == str(je.value)
    m = tmesh.make_mesh({"data": 2, "model": 3},
                        devices=["cpu"] * 6)
    assert tmesh.model_row(m) == [torch.device("cpu")] * 3
    assert tmesh.model_row(m, "data") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="no axis"):
        tmesh.model_row(m, "seq")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh({"model": 2})


def test_default_mesh_shape_matches_jax():
    for n in range(1, 17):
        assert tmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n)


# ------------------------------------------------------- the local frame

def _mid_state(lp, W, frames):
    """The beam after `frames` frames of the single-device decoder, as
    the port's packed [NF, B, W] state and JAX's [NF, B, 128] one."""
    B = lp.shape[1]
    beam, _ = tfd.fused_prefix_decode_plain(torch.from_numpy(lp[:frames]),
                                            tbs._init_beam(B, W, "cpu"))
    packed = tfd.pack_state(beam)
    j_beam = jbs._BeamState(
        h1=jnp.asarray(beam.h1.numpy().astype(np.uint32)),
        h2=jnp.asarray(beam.h2.numpy().astype(np.uint32)),
        hp1=jnp.asarray(beam.hp1.numpy().astype(np.uint32)),
        hp2=jnp.asarray(beam.hp2.numpy().astype(np.uint32)),
        last=jnp.asarray(beam.last.numpy()),
        length=jnp.asarray(beam.length.numpy()),
        tb=jnp.zeros((B, W), jnp.int32),
        live=jnp.asarray(beam.live.numpy()),
        s1=jnp.asarray(beam.s1.numpy()), s2=jnp.asarray(beam.s2.numpy()))
    return packed, jfd.pack_state(j_beam)


@pytest.mark.parametrize("n,W,V,B", [(4, 8, 12, 3), (4, 100, 47, 2)])
def test_tp_frame_plain_matches_jax_fused_tp_frame(n, W, V, B):
    lp = _lp(n * W + V, 4, B, V)
    st, j_st = _mid_state(lp, W, 3)
    f = lp[3]
    last_clip = np.clip(st[tfd.FIELDS.index("last")].numpy(), 0, V - 1)
    j_last = np.clip(np.asarray(j_st[jfd.F_LAST]), 0, V - 1)
    fpad = np.pad(f, ((0, 0), (0, jfd.VP)))
    for lo, hi in tfd.shard_bounds(V, n):
        ys, keys, fin = tfd.tp_frame_plain(
            torch.from_numpy(f[:, lo:hi]),
            torch.from_numpy(np.take_along_axis(f, last_clip, 1)),
            torch.from_numpy(f[:, 0].copy()), st, lo, hi, V)
        j_ys, j_sidx, j_fin = jfd.fused_tp_frame(
            jnp.asarray(fpad[:, lo:lo + jfd.VP]),
            jnp.asarray(np.take_along_axis(f, j_last, 1)),
            jnp.asarray(np.broadcast_to(f[:, :1], (B, jfd.S))), j_st,
            jnp.asarray([lo, hi], jnp.int32), W=W, V=V, blank_id=0,
            pack=jfd.tp_pack(V, n, W), interpret=True)
        j_sidx = np.asarray(j_sidx)[:, :W]
        gidx = tfd.key_index(keys).numpy()
        np.testing.assert_array_equal(gidx // V, j_sidx >> 7)       # w
        np.testing.assert_array_equal(gidx % V, lo + (j_sidx & 127))  # v
        np.testing.assert_array_equal(ys.numpy(), np.asarray(j_ys)[:, :W])
        j_fin = np.asarray(j_fin)[:, :, :W]
        for i, name in enumerate(tfd.FIELDS):
            if name in ("s1", "s2"):
                np.testing.assert_allclose(fin[i].view(torch.float32).numpy(),
                                           j_fin[i].view(np.float32),
                                           rtol=SCORE_TOL, atol=SCORE_TOL)
            else:
                np.testing.assert_array_equal(fin[i].numpy(), j_fin[i], name)


def test_tp_frame_on_cpu_is_the_plain_version_and_keys_order():
    lp = _lp(3, 3, 2, 11)
    st, _ = _mid_state(lp, 6, 2)
    f = torch.from_numpy(lp[2])
    last = st[tfd.FIELDS.index("last")].long().clamp(0, 10)
    args = (f[:, 4:9], torch.gather(f, 1, last),
            f[:, 0].contiguous(), st, 4, 9, 11)
    n0 = tfd.tp_frame_launches
    got = tfd.tp_frame(*args)
    assert tfd.tp_frame_launches == n0
    for a, b in zip(got, tfd.tp_frame_plain(*args)):
        assert torch.equal(a, b)
    keys = got[1]
    assert torch.equal(keys, torch.sort(keys, 1, descending=True).values)
    v = tfd.key_index(keys) % 11
    assert bool(((v >= 4) & (v < 9)).all())          # the window's ids only


def test_tp_frame_merged_plain_of_the_state_is_tp_frame_plain():
    # the loop's frame with one input list that is the state is the
    # JAX-shaped single frame; with the shards' lists it merges them first
    lp = _lp(9, 4, 3, 13)
    st, _ = _mid_state(lp, 7, 3)
    f = torch.from_numpy(lp[3])
    last = st[tfd.FIELDS.index("last")].long().clamp(0, 12)
    for lo, hi in tfd.shard_bounds(13, 3):
        prev, got = tfd.tp_frame_merged_plain(f, None, None, st[None], lo, hi,
                                              13)
        want = tfd.tp_frame_plain(f[:, lo:hi], torch.gather(f, 1, last),
                                  f[:, 0].contiguous(), st, lo, hi, 13)
        assert prev is None
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    outs = [tfd.tp_frame_plain(f[:, lo:hi], torch.gather(f, 1, last),
                               f[:, 0].contiguous(), st, lo, hi, 13)
            for lo, hi in tfd.shard_bounds(13, 3)]
    keys, ys, fins = (torch.stack([o[i] for o in outs]) for i in (1, 0, 2))
    merged, ys_m = tfd.tp_merge_plain(keys, ys, fins)
    beam, ys1 = tfd.fused_prefix_decode_plain(torch.from_numpy(lp),
                                              tbs._init_beam(3, 7, "cpu"))
    assert torch.equal(merged, tfd.pack_state(beam))
    assert torch.equal(ys_m, ys1[3])


# (n, cards, W, V, cluster limit) -> the design, or None: no design admits
@pytest.mark.parametrize("n,cards,W,V,limit,want", [
    (1, 1, 100, 47, 16, "cluster"),
    (2, 1, 100, 47, 16, "cluster"),
    (2, 1, 100, 47, 1, "push"),        # the card holds no cluster of 2
    (4, 1, 100, 47, 16, "push"),       # past TP_CLUSTER_PICK
    (8, 1, 16, 129, 8, "push"),
    (16, 1, 8, 40, 16, "push"),
    (20, 1, 8, 40, 16, "push"),        # past any cluster
    (4, 4, 100, 47, 16, "push"),       # one shard a card
    (4, 2, 100, 47, 16, "push"),
    (2, 2, 16, 256, 16, "push"),
    (1, 1, 128, 256, 16, None),        # a window of 256 > 128
    (2, 1, 129, 47, 16, None),         # W > 128
    (2, 1, 0, 47, 16, None),
    (4, 1, 8, 300, 16, None),          # V > 256 (the scan keeps the row)
    (13, 1, 8, 12, 16, None),          # n > V
    (2, 3, 8, 47, 16, None),           # more cards than shards
    (0, 1, 8, 47, 16, None),
])
def test_pick_design(n, cards, W, V, limit, want):
    if want is None:
        with pytest.raises(ValueError):
            tfd.pick_design(n, cards, W, V, limit)
    else:
        assert tfd.pick_design(n, cards, W, V, limit) == want


def test_tp_kernels_on_cpu_take_the_plain_versions():
    # tp_scan / tp_frames on CPU tensors: the plain merged loop, no launch
    lp = torch.from_numpy(_lp(4, 6, 2, 11))
    init = tfd.pack_state(tbs._init_beam(2, 5, "cpu"))
    f0, s0 = tfd.tp_frame_launches, tfd.tp_scan_launches
    fins, ys = tfd.tp_scan(lp, init, CPU8[:3])
    fin, ys2 = tfd.tp_frames(lp, init, CPU8[:3])
    assert (tfd.tp_frame_launches, tfd.tp_scan_launches) == (f0, s0)
    beam, ys1 = tfd.fused_prefix_decode_plain(lp, tbs._init_beam(2, 5, "cpu"))
    assert torch.equal(ys, ys1) and torch.equal(ys2, ys1)
    assert torch.equal(fin, tfd.pack_state(beam))
    for s in range(3):
        assert torch.equal(fins[s], fin)


# ----------------------------------------------------- batch decode

_SHAPES = [(4, 8, 12, 8, 3), (8, 6, 29, 6, 2), (4, 8, 12, 15, 3),
           (8, 6, 29, 10, 2), (3, 10, 29, 6, 2), (4, 100, 47, 5, 2)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,W,V,T,B", _SHAPES)
def test_ctc_beam_search_tp_matches_jax(n, W, V, T, B, impl):
    lp = _lp(n * 31 + V, T, B, V)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=32,
                               algorithm="prefix", merge_impl="matched")
    mesh = tmesh.make_mesh({"model": n}, devices=CPU8)
    got = ttp.ctc_beam_search_tp(torch.from_numpy(lp), beam_width=W,
                                 mesh=mesh, max_len=32, tp_impl=impl)
    _matches_jax(got, want)
    _bits_equal(got, tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                                         max_len=32, merge_impl="matched"))


@pytest.mark.parametrize("impl", IMPLS)
def test_ctc_beam_search_tp_tie_heavy(impl):
    # uniform logits: every candidate ties every frame
    T, B, V, W, n = 7, 2, 13, 12, 4
    lp = np.full((T, B, V), -np.log(V), np.float32)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=32,
                               merge_impl="matched")
    got = ttp.ctc_beam_search_tp(
        torch.from_numpy(lp), beam_width=W, max_len=32, tp_impl=impl,
        mesh=tmesh.make_mesh({"model": n}, devices=CPU8))
    _matches_jax(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_ctc_beam_search_tp_tie_at_the_local_boundary(impl):
    # exact ties across the W-th place of a shard's local list: JAX's
    # "xla" shard step ranks a stay after its shard's extends and leaves
    # the matched decode here (ROADMAP Queue 3); the port ranks every
    # candidate by its global index and stays equal to it
    T, B, V, W, n = 6, 2, 8, 3, 2
    lp = np.full((T, B, V), -np.log(V), np.float32)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=32,
                               merge_impl="matched")
    got = ttp.ctc_beam_search_tp(
        torch.from_numpy(lp), beam_width=W, max_len=32, tp_impl=impl,
        mesh=tmesh.make_mesh({"model": n}, devices=CPU8))
    _matches_jax(got, want)


@pytest.mark.parametrize("impl", IMPLS + ("auto",))
def test_ctc_beam_search_tp_data_model_mesh(impl):
    lp = _lp(5, 5, 2, 12)
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=8, max_len=32,
                               merge_impl="matched")
    mesh = tmesh.make_mesh({"data": 2, "model": 2}, devices=CPU8)
    got = ttp.ctc_beam_search_tp(torch.from_numpy(lp), beam_width=8,
                                 mesh=mesh, max_len=32, tp_impl=impl)
    _matches_jax(got, want)


def test_ctc_beam_search_tp_beam_wider_than_vocab():
    # W > V: early frames hold fewer live candidates than slots, so the
    # DEAD ones fill the beam in global-index order on every path
    lp = _lp(11, 9, 3, 10)
    want = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=40,
                               max_len=16, merge_impl="matched")
    mesh = tmesh.make_mesh({"model": 4}, devices=CPU8)
    for impl in IMPLS:
        got = ttp.ctc_beam_search_tp(torch.from_numpy(lp), beam_width=40,
                                     mesh=mesh, max_len=16, tp_impl=impl)
        _bits_equal(got, want)
    # and the beams' internal state, dead slots included
    init = tfd.pack_state(tbs._init_beam(3, 40, "cpu"))
    fin, ys = tfd.tp_scan_plain(torch.from_numpy(lp), init, 4)
    beam, ys1 = tfd.fused_prefix_decode_plain(torch.from_numpy(lp),
                                              tbs._init_beam(3, 40, "cpu"))
    assert torch.equal(ys, ys1)
    assert torch.equal(fin[3], tfd.pack_state(beam))


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_ctc_beam_search_tp_more_shards_than_vocab(impl):
    # n > V lies outside both kernels' envelopes; "xla" (and "auto" on CPU
    # tensors) takes it, the shards with empty windows owning no candidate
    lp = torch.from_numpy(_lp(6, 5, 2, 5))
    want = jbs.ctc_beam_search(jnp.asarray(lp.numpy()), beam_width=4,
                               max_len=8, merge_impl="matched")
    got = ttp.ctc_beam_search_tp(
        lp, beam_width=4, max_len=8, tp_impl=impl,
        mesh=tmesh.make_mesh({"model": 8}, devices=CPU8))
    _matches_jax(got, want)
    _bits_equal(got, tbs.ctc_beam_search(lp, beam_width=4, max_len=8))


def test_ctc_beam_search_tp_auto_dispatch():
    lp = torch.from_numpy(_lp(2, 4, 2, 9))
    single = tbs.ctc_beam_search(lp, beam_width=5, max_len=8)
    one = ttp.ctc_beam_search_tp(lp, beam_width=5, max_len=8,
                                 mesh=tmesh.make_mesh({"model": 1},
                                                      devices=CPU8))
    _bits_equal(one, single)
    # n > 1 on CPU tensors: "xla", no kernel wrapper reached
    f0, s0 = tfd.tp_frame_launches, tfd.tp_scan_launches
    four = ttp.ctc_beam_search_tp(lp, beam_width=5, max_len=8,
                                  mesh=tmesh.make_mesh({"model": 4},
                                                       devices=CPU8))
    _bits_equal(four, single)
    assert (tfd.tp_frame_launches, tfd.tp_scan_launches) == (f0, s0)


@pytest.mark.parametrize("impl,W,V,n", [
    ("fused", 129, 47, 2), ("fused", 8, 300, 4), ("fused", 8, 12, 13),
    ("fused_frame", 8, 300, 2), ("fused_frame", 8, 12, 13),
])
def test_tp_envelope_errors_match_jax(impl, W, V, n):
    lp = np.zeros((2, 1, V), np.float32)
    with pytest.raises(ValueError) as je:
        jtp.ctc_beam_search_tp(jnp.asarray(lp), beam_width=W,
                               mesh=jmesh.make_mesh({"model": n},
                                                    jax.devices() * 2),
                               tp_impl=impl)
    with pytest.raises(ValueError) as te:
        ttp.ctc_beam_search_tp(torch.from_numpy(lp), beam_width=W,
                               mesh=tmesh.make_mesh({"model": n},
                                                    devices=CPU8 * 2),
                               tp_impl=impl)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown tp_impl"):
        ttp.ctc_beam_search_tp(torch.from_numpy(lp), beam_width=2,
                               mesh=tmesh.make_mesh({"model": 1},
                                                    devices=CPU8),
                               tp_impl="pallas")


# ----------------------------------------------------------- streaming

@pytest.mark.parametrize("tp_impl,n_tp,chunks", [
    ("xla", 4, (5, 1, 6)),
    ("fused_frame", 4, (5, 1, 6)),
    ("fused_frame", 3, (4, 4)),
    ("fused", 2, (4, 5)),
    ("fused", 4, (3, 3, 3, 3)),
])
def test_streaming_step_tp_equals_tp_batch_and_jax(tp_impl, n_tp, chunks):
    rng_seed = sum(chunks) * 17 + n_tp
    T, B, V, W = sum(chunks), 2, 10, 6
    lp = _lp(rng_seed, T, B, V)
    mesh = tmesh.make_mesh({"model": n_tp}, devices=CPU8)
    full = ttp.ctc_beam_search_tp(torch.from_numpy(lp), beam_width=W,
                                  mesh=mesh, max_len=32, tp_impl=tp_impl)
    single = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=32,
                                 algorithm="prefix", merge_impl="matched")
    st = tbs.streaming_init(B, W, max_len=32, device="cpu")
    t = 0
    for c in chunks:
        st, snap = ttp.streaming_step_tp(st, torch.from_numpy(lp[t:t + c]),
                                         mesh=mesh, tp_impl=tp_impl)
        t += c
    assert st.frames == T
    _bits_equal(snap, full)
    _matches_jax(snap, single)


def test_streaming_step_tp_auto_single_shard_is_streaming_step():
    lp = torch.from_numpy(_lp(4, 6, 2, 7))
    mesh = tmesh.make_mesh({"model": 1}, devices=CPU8)
    a = tbs.streaming_init(2, 4, max_len=8, device="cpu")
    b = tbs.streaming_init(2, 4, max_len=8, device="cpu")
    for c in (lp[:4], lp[4:]):
        a, ra = ttp.streaming_step_tp(a, c, mesh=mesh)
        b, rb = tbs.streaming_step(b, c)
    _bits_equal(ra, rb)
    with pytest.raises(ValueError, match="tp_impl='fused' requires"):
        ttp.streaming_step_tp(a, torch.zeros(2, 2, 300), mesh=mesh,
                              tp_impl="fused")


# ---------------------------------------------- the exchange protocol

def _toy_keys(n, T, Bt, seed):
    rng = np.random.default_rng(seed + n)
    return np.sort(rng.integers(-1000, 1000, (n, T, Bt, 128)),
                   axis=-1)[..., ::-1].astype(np.int32).copy()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_toy_exchange_plain_matches_oracle(n):
    keys = _toy_keys(n, 6, 8, 0)
    got = txp.toy_exchange_scan(torch.from_numpy(keys), n).numpy()
    want = txp.toy_exchange_oracle(keys)
    for s in range(n):
        np.testing.assert_array_equal(got[s], want, f"shard {s}")


def test_toy_exchange_plain_matches_jax_interpret():
    # JAX's toy on 2 of the 8 virtual devices, run as selfcheck runs it
    from jax import lax, shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    n, T, Bt = 2, 6, 8
    keys = _toy_keys(n, T, Bt, 0)

    def run(kd):
        s = lax.axis_index("model").astype(jnp.int32)
        return jxp.toy_exchange_scan(kd[0], jnp.stack([s, s]), n, "model",
                                     (("model", n),), interpret=True)
    want = shard_map(run, mesh=Mesh(np.array(jax.devices()[:n]),
                                    ("model",)),
                     in_specs=(P("model", None, None, None),),
                     out_specs=P("model", None, None),
                     check_vma=False)(jnp.asarray(keys))
    want = np.asarray(want).reshape(n, T, Bt, 128)
    got = txp.toy_exchange_scan(torch.from_numpy(keys), n).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ conformer into TP decode

def test_small_conformer_into_tp_decode_matches_jax():
    # tests/test_decode_tp.py:167-198's slice with unsharded weights: the
    # port's forward on JAX's params, then the TP decode on the preset's
    # own {"data": 2, "model": 4} mesh
    kw = dict(model="conformer_l", batch_size=4, input_size=16, n_context=0,
              linear_size=64, vocab_size=11, seg_len=16, num_blocks=2,
              beam_width=6)
    jc = jcfg.Config(**kw)
    tc = tcfg.Config(device="cpu", **kw)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).uniform(size=(4, 16, 16)).astype(np.float32)
    lp_j = jax.jit(lambda p, xx: j_apply(jc, p, xx))(jp, jnp.asarray(x))
    want = jbs.ctc_beam_search(lp_j, beam_width=6, max_len=16)
    with torch.no_grad():
        lp = model_apply(tc, params_from_jax(jp), torch.from_numpy(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), atol=1e-4)
    mesh = tmesh.make_mesh(tcfg.PRESETS["conformer_l"].mesh_shape,
                           devices=CPU8)
    single = tbs.ctc_beam_search(lp, beam_width=6, max_len=16)
    for impl in IMPLS + ("auto",):
        got = ttp.ctc_beam_search_tp(lp, beam_width=6, mesh=mesh, max_len=16,
                                     tp_impl=impl)
        _bits_equal(got, single)
        for b in range(4):
            n = int(want.lengths[b, 0])
            assert got.tokens[b, 0, :n].tolist() == \
                np.asarray(want.tokens)[b, 0, :n].tolist()
