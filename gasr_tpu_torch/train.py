"""Training step and loop, the port of `gasr_tpu/train.py`: CTC loss over
the acoustic model, global-norm clipping and AdamW, checkpoint / resume.

    python -m gasr_tpu_torch.train [--model deepspeech] [--steps 20]
        [--batch 8] [--hidden 256] [--frames 50] [--checkpoint PATH]
        [--resume] [--device cuda|cpu]

Gradients come from autograd. Where the JAX package differentiates an op
through a custom_vjp (flash attention, the fused stem, the mixed-dtype
convolution and matmul), the port's op is a `torch.autograd.Function`
with the same backward. The recurrence kernels have no backward in
either package, so training runs `rnn_impl="scan"` (the default).

The step is in place: AdamW updates the parameter tensors that
`Optimizer.init` registered (the JAX step returns new arrays and donates
the old ones), and it returns its metrics as tensors without waiting for
the device; the caller synchronises (`Timer.sync`) when it reads them.

`make_sharded_train_step` is the data- and tensor-parallel step of the
deepspeech family, one process per card (`parallel/distributed.py`):
each rank holds its shards of the params and its share of the batch.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from gasr_tpu_torch.config import Config, resolve_device
from gasr_tpu_torch.data.augment import spec_augment
from gasr_tpu_torch.models import model_apply, model_init
from gasr_tpu_torch.models.conformer import _dtype
from gasr_tpu_torch.models.deepspeech import deepspeech_apply_tp
from gasr_tpu_torch.ops.ctc_loss import ctc_loss
from gasr_tpu_torch.parallel.distributed import global_mesh, rank_device
from gasr_tpu_torch.parallel.sharding import (
    batch_specs, deepspeech_param_specs, gather_tree, shard_tree)
from gasr_tpu_torch.runtime._tree import leaves, tensors, tree_map
from gasr_tpu_torch.runtime.profiler import span
from gasr_tpu_torch.runtime.timer import Timer


class Optimizer:
    """The JAX package's `make_optimizer`: optax.chain(clip_by_global_norm(
    1.0), adamw(learning_rate, weight_decay=weight_decay)) with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square root, decay on
    every parameter).

    The clip is optax's: grads divided by their global norm g only when
    g >= 1 (`torch.nn.utils.clip_grad_norm_` divides by g + 1e-6, another
    function). torch's AdamW is optax's adamw: the decoupled decay
    p *= 1 - lr * wd, then the bias-corrected Adam step."""

    def __init__(self, learning_rate: float = 3e-4,
                 weight_decay: float = 1e-6):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def init(self, params: Any) -> torch.optim.AdamW:
        """The optimizer state over every tensor of `params` (which are set
        to require grad and are updated in place by `update`)."""
        leaves = [p.requires_grad_(True) for p in tensors(params)]
        return torch.optim.AdamW(leaves, lr=self.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    @staticmethod
    def update(opt_state: torch.optim.AdamW, grads,
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip `grads` (in the order of the state's parameters) by their
        global norm (`global_norm(grads)` unless `g_norm` is given) and
        take one AdamW step in place; returns the unclipped grads' global
        norm (no host sync). Spans: "optimizer.clip" (the norm and the
        division), "optimizer.step" (AdamW)."""
        grads = list(grads)
        with span("optimizer.clip"):
            if g_norm is None:
                g_norm = global_norm(grads)
            torch._foreach_div_(grads, torch.clamp(g_norm, min=1.0))
        with span("optimizer.step"):
            for p, g in zip(opt_state.param_groups[0]["params"], grads):
                p.grad = g
            opt_state.step()
            opt_state.zero_grad(set_to_none=True)
        return g_norm


def global_norm(grads, sharded=None, group=None) -> torch.Tensor:
    """optax.global_norm, the 2-norm of every element together, as the
    square root of the sum of the leaves' squared norms. With `group`,
    the leaves flagged in `sharded` are this rank's shards of a leaf split
    over the group: their squares are summed over its ranks, and every
    other leaf (replicated) counts once."""
    sq = torch.stack(torch._foreach_norm(grads)) ** 2
    if group is not None:
        whole = sq.clone()
        torch.distributed.all_reduce(whole, group=group)
        mask = torch.tensor(sharded, device=sq.device)
        sq = torch.where(mask, whole, sq)
    return sq.sum().sqrt()


def make_optimizer(learning_rate: float = 3e-4,
                   weight_decay: float = 1e-6) -> Optimizer:
    return Optimizer(learning_rate, weight_decay)


def make_forward(config: Config, remat: bool = False, compute_dtype=None,
                 attn_impl: str = "auto",
                 stem_impl: str = "auto") -> Callable:
    """The step's forward, (params, inputs [B, T, F]) -> log-probs
    [T', B, V+1]: `model_apply` with the step's keywords (each passed only
    where set, as the JAX package does), under a non-reentrant
    `torch.utils.checkpoint` with remat=True (the activations are
    recomputed in the backward)."""
    kw: Dict[str, Any] = {}
    cd = _dtype(compute_dtype)
    if cd is not None:
        kw["compute_dtype"] = cd
    if attn_impl != "auto":
        kw["attn_impl"] = attn_impl
    if stem_impl != "auto":
        kw["stem_impl"] = stem_impl

    def forward(params, inputs):
        return model_apply(config, params, inputs, **kw)

    if not remat:
        return forward
    return lambda params, inputs: checkpoint(forward, params, inputs,
                                             use_reentrant=False)


def batch_loss(log_probs: torch.Tensor, batch: Dict[str, torch.Tensor],
               blank_id: int = 0) -> torch.Tensor:
    """The mean over the batch of each example's CTC loss divided by
    max(label_length, 1)."""
    losses = ctc_loss(log_probs, batch["labels"], batch["input_lengths"],
                      batch["label_lengths"], blank_id=blank_id)
    norm = batch["label_lengths"].float().clamp(min=1.0)
    return (losses / norm).mean()


def make_train_step(config: Config, optimizer: Optimizer,
                    remat: bool = False, compute_dtype=None,
                    augment: bool = False, attn_impl: str = "auto",
                    stem_impl: str = "auto") -> Callable:
    """Returns train_step(params, opt_state, batch, generator=None,
    mark=None) -> (params, opt_state, {"loss", "grad_norm"}), params
    updated in place and the metrics 0-d tensors (grad_norm of the
    unclipped grads). `mark`, where given, is called with each phase's
    name as the phase ends: "forward" (SpecAugment and the model),
    "ctc", "backward", "optimizer" (the benchmark's train loop records
    a CUDA event there). Spans: "train.step", and in it "train.forward",
    "train.ctc", "train.backward" and "train.optimizer", each ending
    where its `mark` fires.

    remat: recompute the forward's activations in the backward.
    compute_dtype: e.g. torch.bfloat16 or "bfloat16", the mixed-precision
    policy (params and loss stay float32). augment: SpecAugment the
    inputs, drawing from `generator` (on the inputs' device).
    attn_impl / stem_impl: the conformer's routes ("auto" | "xla" |
    "pallas"); grads through the flash and stem kernels' forwards are
    supported."""
    forward = make_forward(config, remat, compute_dtype, attn_impl,
                           stem_impl)

    def train_step(params, opt_state, batch, generator=None, mark=None):
        mark = mark or (lambda phase: None)
        leaves = opt_state.param_groups[0]["params"]
        with span("train.step"):
            with span("train.forward"):
                inputs = batch["inputs"]
                if augment:
                    if generator is None:
                        raise ValueError("augment=True needs a generator")
                    inputs = spec_augment(inputs, generator)
                with torch.enable_grad():
                    log_probs = forward(params, inputs)
            mark("forward")
            with torch.enable_grad():
                with span("train.ctc"):
                    loss = batch_loss(log_probs, batch, config.blank_id)
                mark("ctc")
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, leaves,
                                                materialize_grads=True)
                mark("backward")
            with span("train.optimizer"):
                g_norm = optimizer.update(opt_state, grads)
            mark("optimizer")
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": g_norm}

    return train_step


def make_sharded_train_step(config: Config, mesh, optimizer=None,
                            params: Any = None):
    """The data- and tensor-parallel step, the port of JAX's
    `make_sharded_train_step`: returns (step, this rank's params,
    opt_state). Every rank of `mesh` (a DeviceMesh with axes "data" and
    "model", `parallel.distributed.global_mesh`) calls it alike.

    `params` is the whole params tree, alike on every rank (e.g. from
    `runtime.checkpoint.params_from_jax`); by default `model_init` from
    config.seed, drawn on the CPU and so alike everywhere (JAX draws them
    inside from `PRNGKey(config.seed)`). Each rank keeps its shards per
    `deepspeech_param_specs`, so the step serves the deepspeech family
    only, as JAX's does.

    step(params, opt_state, batch, mark=None) -> (params, opt_state,
    {"loss", "grad_norm"}), params updated in place and the metrics 0-d
    tensors not waited for; `mark`, where given, is called with each
    phase's name as it ends: "forward", "ctc", "backward", "allreduce"
    (the grads' all-reduce over "data"), "optimizer"; the spans are
    `make_train_step`'s, with "train.allreduce". `batch` is this
    rank's share
    (`shard_tree(batch, batch_specs(), mesh)`). The forward is
    `deepspeech_apply_tp` over "model" (float32, rnn_impl "scan"); the
    loss is the mean over the "data" ranks of their batch means (equal
    shares: the global batch's mean), and every grad is averaged over
    "data" with it in one all-reduce. The global norm counts each sharded
    leaf's squares over "model" and each replicated leaf once; the clip
    and AdamW then run on the shards."""
    if config.model != "deepspeech":
        raise ValueError("make_sharded_train_step shards the deepspeech "
                         f"family only, got model={config.model!r}")
    optimizer = optimizer or make_optimizer()
    if params is None:
        params = model_init(config, torch.Generator().manual_seed(
            config.seed), device="cpu")
    specs = deepspeech_param_specs(params)
    local = shard_tree(params, specs, mesh)
    opt_state = optimizer.init(local)
    sharded = list(leaves(tree_map(lambda p, s: s.sharded, local, specs)))
    tp, dp = mesh.get_group("model"), mesh.get_group("data")
    n_dp = torch.distributed.get_world_size(dp)

    def step(params, opt_state, batch, mark=None):
        mark = mark or (lambda phase: None)
        leaves_ = opt_state.param_groups[0]["params"]
        with span("train.step"):
            with torch.enable_grad():
                with span("train.forward"):
                    log_probs = deepspeech_apply_tp(params, batch["inputs"],
                                                    tp)
                mark("forward")
                with span("train.ctc"):
                    loss = batch_loss(log_probs, batch, config.blank_id)
                mark("ctc")
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, leaves_,
                                                materialize_grads=True)
                mark("backward")
            with span("train.allreduce"):
                flat = torch.cat([loss.detach().reshape(1)]
                                 + [g.reshape(-1) for g in grads])
                torch.distributed.all_reduce(flat, group=dp)
                flat /= n_dp
            mark("allreduce")
            with span("train.optimizer"):
                parts = flat[1:].split([g.numel() for g in grads])
                grads = [part.view_as(g) for part, g in zip(parts, grads)]
                g_norm = optimizer.update(opt_state, grads,
                                          global_norm(grads, sharded, tp))
            mark("optimizer")
        return params, opt_state, {"loss": flat[0], "grad_norm": g_norm}

    return step, local, opt_state


def sharded_train_run(config: Config, mesh_shape: Dict[str, int],
                      batch: Dict[str, torch.Tensor], params: Any = None,
                      timed_steps: int = 0) -> Dict[str, Any]:
    """One rank's side of a sharded training run, for
    `parallel.distributed.spawn(sharded_train_run, world, device, ...)`:
    the global mesh of `mesh_shape`, `make_sharded_train_step` from
    `params` (default: config.seed), one step on this rank's share of the
    whole `batch`, then `timed_steps` more, timed between barriers.

    Returns {"loss", "grad_norm"} of the first step (floats), "params"
    (after the first step, whole, on the CPU; rank 0 only, else None),
    "ms_per_step" (host clock over the timed steps and a device fence;
    None without them), "peak_bytes" (the rank's peak device memory on a
    card, else None), "mesh"."""
    mesh = global_mesh(mesh_shape)
    dev = rank_device()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step, local, opt_state = make_sharded_train_step(config, mesh,
                                                     params=params)
    local_batch = shard_tree(batch, batch_specs(), mesh)
    local, opt_state, m = step(local, opt_state, local_batch)
    out: Dict[str, Any] = {"loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"]),
                           "mesh": dict(zip(mesh.mesh_dim_names,
                                            mesh.mesh.shape))}
    whole = gather_tree(tree_map(lambda t: t.detach(), local),
                        deepspeech_param_specs(local), mesh)
    out["params"] = (tree_map(lambda t: t.to("cpu", copy=True), whole)
                     if torch.distributed.get_rank() == 0 else None)
    del whole
    out["ms_per_step"] = None
    if timed_steps:
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            local, opt_state, m = step(local, opt_state, local_batch)
        Timer.sync(m)
        torch.distributed.barrier()
        out["ms_per_step"] = (time.perf_counter() - t0) / timed_steps * 1e3
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    return out


def synthetic_batch(config: Config, generator: torch.Generator,
                    max_label_len: int = 20) -> Dict[str, torch.Tensor]:
    """A random batch in the training schema (the JAX package's
    `synthetic_batch`): inputs uniform [B, T, F] float32, labels
    [B, max_label_len] int32 in [1, V], input_lengths T, label_lengths in
    [max_label_len // 2, max_label_len], drawn on the CPU from
    `generator` (so a seed gives the same batch on every device) and
    moved to config.device."""
    B, T, S = config.batch_size, config.seg_len, max_label_len
    i32 = torch.int32
    batch = {
        "inputs": torch.rand((B, T, config.feat_size), generator=generator),
        "labels": torch.randint(1, config.output_size, (B, S),
                                generator=generator, dtype=i32),
        "input_lengths": torch.full((B,), T, dtype=i32),
        "label_lengths": torch.randint(S // 2, S + 1, (B,),
                                       generator=generator, dtype=i32),
    }
    dev = resolve_device(config.device)
    return {k: v.to(dev) for k, v in batch.items()}


def train_loop(config: Config, num_steps: int = 20,
               checkpoint_path: Optional[str] = None, resume: bool = False,
               log_every: int = 5, mesh=None):
    """Train on synthetic batches with checkpoint / resume: the params and
    the step counter round-trip through an npz (`runtime.checkpoint`, the
    JAX package's key scheme); the optimizer state starts anew on resume,
    as in the JAX package. `mesh` is taken and unused, as in the JAX
    package (the sharded step is `make_sharded_train_step`). Returns
    (params, the losses logged)."""
    from gasr_tpu_torch.runtime.checkpoint import load_params, save_params

    optimizer = make_optimizer()
    params = model_init(config, torch.Generator().manual_seed(config.seed))
    start_step = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        blob = load_params(checkpoint_path, {
            "params": params, "step": torch.zeros((), dtype=torch.int32)})
        params = blob["params"]
        start_step = int(blob["step"])
    opt_state = optimizer.init(params)
    step_fn = make_train_step(config, optimizer)

    generator = torch.Generator().manual_seed(1234 + start_step)
    losses = []
    for i in range(start_step, start_step + num_steps):
        batch = synthetic_batch(config, generator)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % log_every == 0 or i == start_step:
            Timer.sync(metrics)
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {i + 1}: loss={loss:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)
    if checkpoint_path:
        save_params(checkpoint_path, {
            "params": params,
            "step": torch.tensor(start_step + num_steps, dtype=torch.int32)})
    return params, losses


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deepspeech")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the step runs (default: the card)")
    args = ap.parse_args()
    cfg = Config(model=args.model, batch_size=args.batch,
                 linear_size=args.hidden, rnn_hidden_size=args.hidden,
                 seg_len=args.frames, vocab_size=28, device=args.device)
    train_loop(cfg, num_steps=args.steps, checkpoint_path=args.checkpoint,
               resume=args.resume)


if __name__ == "__main__":
    main()
