"""The port's multi-process parallel modules against the JAX package, on
the CPU: `parallel/sharding.py` (specs, shard_tree / gather_tree),
`parallel/collectives.py`, the tensor-parallel deepspeech forward,
`train.make_sharded_train_step`, `runtime/checkpoint.py`'s sharded (DCP)
checkpoints, `parallel/distributed.py` and `parallel/scaling.py`.

Ranks are gloo processes started by `distributed.spawn` (one thread
each, a file rendezvous under a temporary directory, timeouts on the
collectives and the join); the rank programs are the port's
(`parallel/checks.py`, `train.sharded_train_run`), and one world runs
many checks (`checks.run_each`). JAX's sharded step runs on conftest's
virtual CPU devices. Params cross by `params_from_jax`, batches as numpy.

Tolerances:
  STEP_RTOL   loss and grad norm of a sharded float32 step against JAX's
              sharded step and the port's single-device step: the same
              float32 ops, summed in other orders (split products, the
              all-reduces).
  PARAM_ATOL  updated params: Adam's first step moves an element by about
              lr = 3e-4 times g / (|g| + 1e-8), so an ulp of g moves it
              far less than 1e-6.
  FWD_ATOL    the tensor-parallel forward's log-probs against
              `deepspeech_apply`: float32 products split by column.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gasr_tpu import config as jcfg
from gasr_tpu import train as jtrain
from gasr_tpu.models import model_init as j_init
from gasr_tpu.parallel import mesh as jmesh, scaling as jscaling
from gasr_tpu.parallel import sharding as jsharding

from gasr_tpu_torch import config as tcfg
from gasr_tpu_torch import train as ttrain
from gasr_tpu_torch.models import model_init
from gasr_tpu_torch.models.deepspeech import deepspeech_apply
from gasr_tpu_torch.parallel import checks, distributed, scaling, sharding
from gasr_tpu_torch.parallel.mesh import mesh_sizes
from gasr_tpu_torch.runtime import checkpoint as tckpt
from gasr_tpu_torch.runtime._tree import leaves

STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
FWD_ATOL = 1e-5


def _ds_pair(dp=2, tp=2, **over):
    kw = dict(batch_size=4 * dp, input_size=6, n_context=1,
              linear_size=8 * tp, rnn_hidden_size=8 * tp, vocab_size=9,
              seg_len=10, **over)
    return jcfg.Config(**kw), tcfg.Config(**kw, device="cpu")


def _jax_params(jc):
    return jax.device_get(j_init(jc, jax.random.PRNGKey(jc.seed)))


def _flat_specs(tree, prefix=""):
    """{"a/b/0/c": axes} of a JAX spec tree (dicts and lists of P)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_specs(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


def _port_flat_specs(tree):
    return {k: s.axes for k, s in tckpt.flat_leaves(tree).items()}


# ------------------------------------------------------------- specs

@pytest.mark.parametrize("layers,bidir", [(1, False), (3, False),
                                          (2, True)])
def test_deepspeech_param_specs_equal_jax(layers, bidir):
    jc, _ = _ds_pair(rnn_num_layers=layers, bidirectional=bidir)
    jp = _jax_params(jc)
    want = _flat_specs(jsharding.deepspeech_param_specs(jp))
    got = _port_flat_specs(sharding.deepspeech_param_specs(
        tckpt.params_from_jax(jp)))
    assert got == want
    assert set(got) == set(tckpt.flatten_params(jp))


@pytest.mark.parametrize("preset,min_dim", [("conformer_l", 16),
                                            ("conformer_l", 256),
                                            ("bilstm_2x256", 256),
                                            ("deepspeech2", 64)])
def test_generic_param_specs_equal_jax(preset, min_dim):
    over = dict(linear_size=32, rnn_hidden_size=32, num_blocks=2,
                input_size=16)
    jc = dataclasses.replace(jcfg.PRESETS[preset], **over)
    jp = jax.device_get(j_init(jc, jax.random.PRNGKey(0)))
    want = _flat_specs(jax.tree.map(
        tuple, jsharding.generic_param_specs(jp, min_dim=min_dim),
        is_leaf=lambda x: isinstance(x, P)))
    got = _port_flat_specs(sharding.generic_param_specs(
        tckpt.params_from_jax(jp), min_dim=min_dim))
    assert got == {k: tuple(v) for k, v in want.items()}


def test_batch_specs_equal_jax():
    want = {k: tuple(v) for k, v in jsharding.batch_specs().items()}
    assert {k: s.axes for k, s in sharding.batch_specs().items()} == want


@pytest.mark.parametrize("shape,n", [({"data": 2, "model": 4}, 8),
                                     ({"data": -1, "model": 2}, 8),
                                     ({}, 3), ({"model": 4}, 4)])
def test_mesh_sizes_follow_make_mesh(shape, n):
    names, sizes = mesh_sizes(shape, n)
    want = jmesh.make_mesh(shape, devices=jax.devices()[:n]).shape
    assert dict(zip(names, sizes)) == dict(want)
    with pytest.raises(ValueError):
        mesh_sizes({"data": n + 1}, n)


# ------------------------------------- one world of 4 gloo ranks, many checks

def _world_inputs(tmp):
    rng = np.random.default_rng(3)
    jc, tc = _ds_pair()
    jp = _jax_params(jc)
    jb = jax.device_get(jtrain.synthetic_batch(jc, jax.random.PRNGKey(0),
                                               max_label_len=4))
    params = tckpt.params_from_jax(jp)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    _, tc_bi = _ds_pair(dp=1, tp=4, rnn_num_layers=2, bidirectional=True)
    params_bi = model_init(tc_bi, torch.Generator().manual_seed(5))
    x = torch.from_numpy(rng.uniform(size=(8, 10, tc.feat_size)).astype(
        np.float32))
    ccfg = dataclasses.replace(tcfg.PRESETS["conformer_l"], linear_size=64,
                               num_blocks=2, input_size=8, vocab_size=11,
                               device="cpu")
    cparams = model_init(ccfg)
    cspecs = sharding.generic_param_specs(cparams, min_dim=16)
    xs = [torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(np.float32))
          for _ in range(4)]
    gs = {"all_gather": [torch.from_numpy(rng.standard_normal(
              (3, 8, 5)).astype(np.float32)) for _ in range(4)],
          # the loss downstream of an all-reduce is replicated: one
          # cotangent on every rank
          "all_reduce": [torch.from_numpy(rng.standard_normal(
              (3, 2, 5)).astype(np.float32))] * 4,
          "copy_to_group": [torch.from_numpy(rng.standard_normal(
              (3, 2, 5)).astype(np.float32)) for _ in range(4)]}
    calls = [
        (checks.collectives_run, (xs, gs, 1)),
        (checks.roundtrip_run, (params, sharding.deepspeech_param_specs(
            params), {"data": 2, "model": 2})),
        (checks.roundtrip_run, (cparams, cspecs, {"data": 1, "model": 4})),
        (checks.tp_forward_run, (params, x, {"data": 2, "model": 2})),
        (checks.tp_forward_run, (params_bi, x[:4], {"data": 1, "model": 4})),
        (ttrain.sharded_train_run, (tc, {"data": 2, "model": 2}, batch,
                                    params)),
        (checks.checkpoint_run, (str(tmp / "ckpt"), params,
                                 {"data": 2, "model": 2}, {"model": 4})),
    ]
    inputs = dict(jc=jc, tc=tc, jp=jp, jb=jb, params=params, batch=batch,
                  params_bi=params_bi, x=x, xs=xs, gs=gs, ckpt=tmp / "ckpt")
    return inputs, calls


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    inputs, calls = _world_inputs(tmp_path_factory.mktemp("world4"))
    ranks = distributed.spawn(checks.run_each, 4, "cpu", calls, threads=1,
                              timeout_s=240)
    return inputs, ranks


def test_spawn_returns_every_rank(world4):
    _, ranks = world4
    assert len(ranks) == 4 and all(len(r) == 7 for r in ranks)


@pytest.mark.parametrize("which", [1, 2])
def test_shard_then_gather_is_bit_equal(world4, which):
    _, ranks = world4
    assert all(r[which]["equal"] for r in ranks)
    # the ranks hold different shards of one shape
    assert len({tuple(r[which]["shapes"]) for r in ranks}) == 1


@pytest.mark.parametrize("op", ["all_gather", "all_reduce", "copy_to_group"])
def test_collective_matches_single_process_twin(world4, op):
    inputs, ranks = world4
    xs, gs = inputs["xs"], inputs["gs"][op]
    if op == "all_gather":
        X = torch.cat(xs, dim=1).requires_grad_()
        y = X
        loss = sum((g * X).sum() for g in gs)
        gX = torch.autograd.grad(loss, X)[0].split(2, dim=1)
        want = [(y.detach(), gX[r]) for r in range(4)]
    elif op == "all_reduce":
        X = [x.clone().requires_grad_() for x in xs]
        y = torch.stack(X).sum(0)
        grads = torch.autograd.grad((gs[0] * y).sum(), X)
        want = [(y.detach(), grads[r]) for r in range(4)]
    else:
        x = xs[0].clone().requires_grad_()
        loss = sum((g * x).sum() for g in gs)
        gx = torch.autograd.grad(loss, x)[0]
        want = [(xs[0], gx)] * 4
    for r in range(4):
        y, g = ranks[r][0][op]
        torch.testing.assert_close(y, want[r][0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g, want[r][1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which,params_key,rows", [(3, "params", 2),
                                                   (4, "params_bi", 1)])
def test_tp_forward_matches_deepspeech_apply(world4, which, params_key,
                                             rows):
    inputs, ranks = world4
    x = inputs["x"] if rows == 2 else inputs["x"][:4]
    want = deepspeech_apply(inputs[params_key], x)
    per = x.shape[0] // rows
    for r, rank in enumerate(ranks):
        d = r // (4 // rows)
        torch.testing.assert_close(rank[which],
                                   want[:, d * per:(d + 1) * per],
                                   rtol=0, atol=FWD_ATOL)


def _assert_step(run, loss, gnorm, params):
    np.testing.assert_allclose(run["loss"], loss, rtol=STEP_RTOL)
    np.testing.assert_allclose(run["grad_norm"], gnorm, rtol=STEP_RTOL)
    got = tckpt.flatten_params(run["params"])
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_sharded_step_matches_jax_sharded_step(world4):
    inputs, ranks = world4
    jc, jb = inputs["jc"], inputs["jb"]
    mesh = jmesh.make_mesh({"data": 2, "model": 2})
    with mesh:
        step, jp, opt_state = jtrain.make_sharded_train_step(jc, mesh)
        sbatch = jsharding.shard_tree(
            {k: jnp.asarray(v) for k, v in jb.items()},
            jsharding.batch_specs(), mesh)
        jp2, _, jm = step(jp, opt_state, sbatch)
    run = ranks[0][5]
    assert run["mesh"] == {"data": 2, "model": 2}
    assert float(jm["grad_norm"]) > 1.0            # the clip took effect
    _assert_step(run, float(jm["loss"]), float(jm["grad_norm"]),
                 tckpt.flatten_params(jax.device_get(jp2)))
    assert all(r[5]["params"] is None for r in ranks[1:])


def test_sharded_step_matches_single_device_step(world4):
    inputs, ranks = world4
    params = tckpt.params_from_jax(inputs["jp"])
    opt = ttrain.make_optimizer()
    _, _, m = ttrain.make_train_step(inputs["tc"], opt)(
        params, opt.init(params), inputs["batch"])
    _assert_step(ranks[0][5], float(m["loss"]), float(m["grad_norm"]),
                 tckpt.flatten_params(params))
    # every rank reports the same (all-reduced) metrics
    assert len({(r[5]["loss"], r[5]["grad_norm"]) for r in ranks}) == 1


def test_dcp_checkpoint_across_meshes(world4):
    inputs, ranks = world4
    want = tckpt.flatten_params(inputs["params"])
    # saved from {"data": 2, "model": 2}, loaded into {"model": 4}
    assert all(r[6]["equal"] for r in ranks)
    got = tckpt.flatten_params(ranks[0][6]["params"])
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # and into one process with no process group, whole
    like = tckpt.params_from_jax(inputs["jp"])
    for t in leaves(like):
        t.zero_()
    whole = tckpt.flatten_params(tckpt.load_params_dcp(
        str(inputs["ckpt"]), like))
    assert all(np.array_equal(whole[k], want[k]) for k in want)


# ------------------------------------------------------ one rank alone

def test_sharded_step_at_one_rank_is_the_single_device_step():
    _, tc = _ds_pair(dp=1, tp=1)
    params = model_init(tc)
    batch = ttrain.synthetic_batch(tc, torch.Generator().manual_seed(1),
                                   max_label_len=4)
    (run,) = distributed.spawn(ttrain.sharded_train_run, 1, "cpu", tc,
                               {"data": 1, "model": 1}, batch, params,
                               threads=1, timeout_s=120)
    opt = ttrain.make_optimizer()
    _, _, m = ttrain.make_train_step(tc, opt)(params, opt.init(params),
                                              batch)
    assert run["loss"] == float(m["loss"])
    assert run["grad_norm"] == float(m["grad_norm"])
    got = tckpt.flatten_params(run["params"])
    for k, v in tckpt.flatten_params(params).items():
        assert np.array_equal(got[k], v), k


# ------------------------------------------------- bring-up and launcher

def test_initialize_is_a_no_op_without_the_launcher_variables(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_host_local_batch_needs_a_spec_for_every_key():
    with pytest.raises(KeyError, match="extra"):
        distributed.host_local_batch_to_global(
            {"inputs": np.zeros((2, 3, 4)), "extra": np.zeros(2)}, None,
            sharding.batch_specs())


def test_spawn_raises_with_the_failed_rank_and_refuses_cards():
    # a mesh of 3 ranks in a world of 2 raises in every rank
    with pytest.raises(RuntimeError, match="needs 3 devices"):
        distributed.spawn(checks.run_each, 2, "cpu",
                          [(distributed.global_mesh, ({"data": 3},))],
                          threads=1, timeout_s=120)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.spawn(checks.run_each, 1, "cuda", [])



def test_spawn_leaves_no_process_running():
    # every rank has ended when spawn returns, and no helper process of
    # the launcher outlives it
    assert distributed.spawn(checks.run_each, 2, "cpu", [], threads=1,
                             timeout_s=120) == [[], []]
    assert distributed.live_children() == []


# ------------------------------------------------------------- scaling

def test_param_bytes_equal_jax():
    jc, tc = _ds_pair()
    assert scaling.param_bytes(tc) == jscaling.param_bytes(jc)
    assert scaling.param_bytes(tc, 2) == jscaling.param_bytes(jc, 2)


@pytest.mark.parametrize("overlap", [0.8, 0.0])
def test_projection_rows_equal_jax_at_the_same_bandwidth(overlap):
    # JAX's rows at n <= CHIPS_PER_HOST price its ICI constant; the port
    # takes the rate as an argument, here the same one
    jc, tc = _ds_pair()
    counts = [1, 2, 4, 8]
    want = jscaling.analytic_dp_projection(jc, counts, 0.08,
                                           overlap=overlap)
    got = scaling.analytic_dp_projection(tc, counts, 0.08,
                                         jscaling.ICI_BW_B_S,
                                         overlap=overlap)
    for w, g in zip(want, got):
        for k in ("devices", "global_batch", "iter_s", "audio_s_per_s",
                  "t_comm_raw_ms", "t_comm_exposed_ms", "efficiency",
                  "efficiency_overlap0"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)


def test_measure_dp_scaling_on_gloo_ranks():
    cfg = tcfg.Config(batch_size=4, linear_size=64, rnn_hidden_size=64,
                      seg_len=20, beam_width=4, device="cpu")
    rows = scaling.measure_dp_scaling(cfg, [1, 2, os.cpu_count() + 1],
                                      iters=2, decode=True)
    assert [r["devices"] for r in rows] == [1, 2]   # a rank a core at most
    assert [r["global_batch"] for r in rows] == [4, 8]
    for r in rows:
        assert np.isfinite(r["iter_s"]) and r["iter_s"] > 0
        np.testing.assert_allclose(
            r["audio_s_per_s"], r["global_batch"] * 20 * 0.01 / r["iter_s"])
        assert len(r["launches"]) == r["devices"]
        assert r["launches"] == [{}] * r["devices"]     # CPU: no kernel
    assert rows[0]["efficiency"] == 1.0


def test_fixed_work_and_allreduce_rate_on_gloo_ranks():
    small = tcfg.Config(batch_size=8, linear_size=32, rnn_hidden_size=32,
                        seg_len=16, vocab_size=28, device="cpu")
    mv = scaling.measure_fixed_work_virtual(small, n_hi=2, iters=2)
    assert mv["n_hi"] == 2 and mv["global_batch"] == 8
    assert mv["host_cpus"] == os.cpu_count()
    np.testing.assert_allclose(mv["efficiency_measured"],
                               mv["t_1dev_s"] / mv["t_ndev_s"])
    assert mv["within_tolerance"] == (abs(mv["efficiency_measured"] - 1)
                                      <= 0.25)
    ar = scaling.measure_allreduce_bandwidth(2, 1 << 16, "cpu", iters=3)
    assert ar["bus_b_s"] == pytest.approx((1 << 16) / ar["s"])
