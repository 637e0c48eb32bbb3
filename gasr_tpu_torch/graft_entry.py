"""Entry points of the port, the counterparts of the repo root's
`__graft_entry__.py` (which serves the JAX package).

entry(device): the flagship forward (DeepSpeech CTC, 512 wide) and its
arguments, on the card unless the caller asks for the CPU.

dryrun_multichip(n, device): the capability surface across n ranks and
devices, each part held to a single device:
  - `default_mesh_shape(n)`;
  - one sharded training step (`train.make_sharded_train_step`, data and
    tensor parallel) on a tiny deepspeech over n ranks, one process per
    card (gloo processes on the CPU): the loss finite and, beyond JAX's
    check, loss, grad norm and updated params equal to the single-device
    step's within `STEP_RTOL` / `PARAM_ATOL`;
  - the vocab-sharded decode on the single-process `parallel.mesh.Mesh`
    of the same shape: "fused_frame" on the whole model axis and the
    whole-scan "fused" kernel on a model submesh of at most 4, each
    bit-equal to `ctc_beam_search` (also at one model shard, where JAX's
    "auto" takes the single-device decoder);
  - the TP streaming decode in chunks (0, 4), (4, 7), (7, 10), bit-equal
    to the batch decode;
  - a 2-block conformer_l slice: params split by
    `generic_param_specs(min_dim=16)` and the batch on "data" across the
    ranks, the log-probs gathered, then the TP decode: tokens equal to
    the single-device decode's. JAX keeps the column-split weights split
    and lets GSPMD place the collectives ("column-parallel everywhere
    keeps activations replicated"); here each rank gathers the split
    weights over "model" before its forward, which is one valid lowering
    of the same layout (activations replicated, the weights' storage
    split between steps).

On cards, n ranks need n cards (NCCL refuses two ranks on one card):
more than `torch.cuda.device_count()` raises, and nothing gives way to
the CPU or to a repeated card.
"""

from __future__ import annotations

import numpy as np
import torch

STEP_RTOL = 1e-5   # loss and grad norm, sharded against single-device: the
                   # same float32 ops, summed in other orders (the split
                   # products, the all-reduces)
PARAM_ATOL = 1e-6  # updated params: Adam's first step moves an element by
                   # about lr = 3e-4 times g / (|g| + 1e-8), so an ulp of g
                   # moves it far less


def entry(device: str = "cuda"):
    """(fn, (params, x)): fn(params, x) is the deepspeech forward of
    __graft_entry__.py's config (B=32, T=100, 78 features, width 512,
    V=46 + blank), params from seed 0 and x uniform from seed 1."""
    from gasr_tpu_torch.config import Config
    from gasr_tpu_torch.models import model_apply, model_init

    cfg = Config(batch_size=32, input_size=26, n_context=1,
                 linear_size=512, rnn_hidden_size=512, vocab_size=46,
                 seg_len=100, device=device)
    params = model_init(cfg, torch.Generator().manual_seed(0))
    x = torch.rand((cfg.batch_size, cfg.seg_len, cfg.feat_size),
                   generator=torch.Generator().manual_seed(1)).to(
                       params["mlp1"]["w"].device)

    def fn(params, x):
        return model_apply(cfg, params, x)

    return fn, (params, x)


def conformer_slice_run(cfg, params, x, mesh_shape):
    """One rank's side of the conformer_l slice: this rank's shards of
    `params` (generic specs, min_dim 16) gathered whole over "model"
    before the forward, its rows of x over "data"; the log-probs of every
    row gathered over "data" (on the CPU, rank 0; else None)."""
    import torch.distributed as dist
    from gasr_tpu_torch.models import model_apply
    from gasr_tpu_torch.parallel.distributed import global_mesh
    from gasr_tpu_torch.parallel.sharding import (Spec, gather_tree,
                                                  generic_param_specs,
                                                  shard_tree)
    mesh = global_mesh(mesh_shape)
    specs = generic_param_specs(params, min_dim=16)
    local = shard_tree(params, specs, mesh)
    x_local = shard_tree(x, Spec("data"), mesh)
    with torch.no_grad():
        lp = model_apply(cfg, gather_tree(local, specs, mesh), x_local)
        lp = gather_tree(lp, Spec(None, "data"), mesh)
    return lp.cpu() if dist.get_rank() == 0 else None


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The checks of the module docstring over n ranks (n cards, or gloo
    processes with device="cpu"); raises on the first that fails, prints
    a line for each that passes."""
    import dataclasses

    from gasr_tpu_torch.config import Config, resolve_device
    from gasr_tpu_torch.decoder import ctc_beam_search
    from gasr_tpu_torch.decoder.beam_search import streaming_init
    from gasr_tpu_torch.models import model_apply, model_init
    from gasr_tpu_torch.parallel import checks
    from gasr_tpu_torch.parallel.decode_tp import (ctc_beam_search_tp,
                                                   streaming_step_tp)
    from gasr_tpu_torch.parallel.distributed import spawn
    from gasr_tpu_torch.parallel.mesh import default_mesh_shape, make_mesh
    from gasr_tpu_torch.runtime._tree import tree_map
    from gasr_tpu_torch.runtime.checkpoint import flatten_params
    from gasr_tpu_torch.train import (make_optimizer, make_train_step,
                                      sharded_train_run, synthetic_batch)

    dev = resolve_device(device)
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"CUDA cards, torch finds "
                         f"{torch.cuda.device_count()}")
    shape = default_mesh_shape(n_devices)
    dp, tp = shape.get("data", 1), shape.get("model", 1)

    # ---- the sharded train step and the conformer slice, one world
    cfg = Config(batch_size=4 * dp, input_size=8, n_context=1,
                 linear_size=8 * tp, rnn_hidden_size=8 * tp,
                 vocab_size=11, seg_len=16, rnn_num_layers=1, device="cpu")
    params = model_init(cfg)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(0),
                            max_label_len=5)
    ccfg = Config(model="conformer_l", batch_size=2 * dp, input_size=8,
                  n_context=0, linear_size=16 * tp, vocab_size=11,
                  seg_len=8, num_blocks=2, beam_width=4, device="cpu")
    cparams = model_init(ccfg, torch.Generator().manual_seed(2))
    cx = torch.rand((ccfg.batch_size, ccfg.seg_len, 8),
                    generator=torch.Generator().manual_seed(3))
    (run, lp_c), *_ = spawn(
        checks.run_each, n_devices, device,
        [(sharded_train_run, (cfg, shape, batch, params)),
         (conformer_slice_run, (ccfg, cparams, cx, shape))],
        threads=1 if device == "cpu" else None)
    loss = run["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    # the single-device step from the same params and batch
    cfg1 = dataclasses.replace(cfg, device=device)
    p1 = model_init(cfg1)                       # the same seed, on `dev`
    opt = make_optimizer()
    _, _, m1 = make_train_step(cfg1, opt)(
        p1, opt.init(p1), {k: v.to(dev) for k, v in batch.items()})
    np.testing.assert_allclose(loss, float(m1["loss"]), rtol=STEP_RTOL)
    np.testing.assert_allclose(run["grad_norm"], float(m1["grad_norm"]),
                               rtol=STEP_RTOL)
    want_p = flatten_params(p1)
    for k, v in flatten_params(run["params"]).items():
        np.testing.assert_allclose(v, want_p[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    print(f"dryrun_multichip(n={n_devices}, mesh={shape}, {device}): "
          f"loss={loss:.4f} == single-device {float(m1['loss']):.4f}, "
          f"grad norm and params too OK", flush=True)

    # ---- decode side: the vocab-sharded beam search on the single-process
    # mesh of the same shape, bit-checked against the single device
    devices = None if device == "cuda" else [dev] * n_devices
    mesh = make_mesh(shape, devices=devices)
    mesh_dev = mesh.devices.ravel()[0]
    rng = np.random.default_rng(0)
    z = rng.standard_normal((10, 2, 13)).astype(np.float32)
    lp = torch.from_numpy(z - np.log(np.exp(z).sum(-1, keepdims=True))).to(
        mesh_dev)
    want = ctc_beam_search(lp, beam_width=6, max_len=16)

    def same(got, ref, what):
        for f in ("tokens", "scores", "lengths"):
            if not torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()):
                raise AssertionError(f"{what}: {f} differ from the "
                                     f"single-device decode")

    got = ctc_beam_search_tp(lp, beam_width=6, mesh=mesh, max_len=16,
                             tp_impl="fused_frame")
    same(got, want, f"TP({tp}) fused_frame")
    print(f"dryrun_multichip decode: TP({tp}) fused_frame beam search "
          f"bit-equal to single-device OK", flush=True)
    n_scan = min(4, n_devices)
    smesh = make_mesh({"model": n_scan},
                      devices=list(mesh.devices.ravel()[:n_scan]))
    got_s = ctc_beam_search_tp(lp[:4], beam_width=6, mesh=smesh, max_len=16,
                               tp_impl="fused")
    same(got_s, ctc_beam_search(lp[:4], beam_width=6, max_len=16),
         f"TP({n_scan}) fused")
    print(f"dryrun_multichip decode: TP({n_scan}) whole-scan kernel "
          f"bit-equal to single-device OK", flush=True)

    st = streaming_init(2, 6, max_len=16, device=mesh_dev)
    for t0, t1 in ((0, 4), (4, 7), (7, 10)):
        st, snap = streaming_step_tp(st, lp[t0:t1], mesh=mesh,
                                     tp_impl="fused_frame")
    same(snap, want, f"TP({tp}) streaming")
    print(f"dryrun_multichip decode: TP({tp}) STREAMING chunk sequence "
          f"bit-equal to single-device batch OK", flush=True)

    # ---- conformer_l slice: sharded forward -> TP decode
    with torch.no_grad():
        lp_ref = model_apply(ccfg, tree_map(lambda t: t.to(mesh_dev),
                                            cparams), cx.to(mesh_dev))
    want_c = ctc_beam_search(lp_ref, beam_width=4, max_len=16)
    got_c = ctc_beam_search_tp(lp_c.to(mesh_dev), beam_width=4, mesh=mesh,
                               max_len=16, tp_impl="fused_frame")
    if not torch.isfinite(got_c.scores[:, 0]).all():
        raise AssertionError("conformer slice: non-finite top scores")
    for b in range(ccfg.batch_size):
        n_tok = int(want_c.lengths[b, 0])
        if got_c.tokens[b, 0, :n_tok].tolist() != \
                want_c.tokens[b, 0, :n_tok].tolist():
            raise AssertionError(f"conformer slice: utterance {b}'s tokens "
                                 f"differ from the single-device decode")
    print("dryrun_multichip conformer_l: sharded fwd + TP fused decode "
          "parity OK", flush=True)
