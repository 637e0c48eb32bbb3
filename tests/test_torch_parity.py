"""The port's public API against the JAX package's.

For every module of `gasr_tpu` outside `ops/pallas` (whose kernels the
port replaces in `gasr_tpu_torch/ops/cuda`), each public function and
class defined there has a counterpart of the same name in the same module
of `gasr_tpu_torch`, taking the same parameters in the same order (a
class: its constructor's, a NamedTuple's fields). The departures allowed
are the port's settled rules (ROADMAP.md, Queue 3, "Settled"):
  - RENAMED: a `jax.random` key becomes a `torch.Generator` (`key` ->
    `generator`);
  - ADDED: `device`, where an entry point makes tensors (the card unless
    the caller asks for the CPU);
  - DEPARTURES: a few names whose signature differs for a stated reason;
    each entry pins the port's parameters, and must still be needed;
  - REMOVED: names the port left out for a stated reason; each must
    still be in the JAX package and not in the port.
The other way round, every module of `gasr_tpu_torch` is the counterpart
of a `gasr_tpu` module or is on PORT_ONLY with its reason: the package
mirrors JAX's layout module for module.
Imports both packages and runs nothing.
"""

import importlib
import inspect
from pathlib import Path

import pytest

import gasr_tpu
import gasr_tpu_torch

RENAMED = {"key": "generator"}
ADDED = {"device"}

# (module, JAX name) -> (port name, the port's parameters, reason)
DEPARTURES = {
    ("gasr_tpu.decoder.beam_search", "StreamingState"): (
        "StreamingState", ["beam", "tokens", "timesteps", "frames"],
        "JAX's `meta` holds the TPU kernel's [B, Lp, 128] layout of the "
        "prefixes, which means nothing on the card"),
    ("gasr_tpu.eval", "main"): (
        "main", ["argv"], "the CLI takes its argument list, so that tests "
        "drive it in-process"),
    ("gasr_tpu.infer", "main"): (
        "main", ["argv"], "the CLI takes its argument list, so that tests "
        "drive it in-process"),
    ("gasr_tpu.parallel.distributed", "initialize"): (
        "initialize", ["device", "init_method", "timeout_s"],
        "torch.distributed's rendezvous (RANK / WORLD_SIZE as torchrun "
        "sets them, or init_method) takes the place of JAX's coordinator; "
        "one process a card"),
    ("gasr_tpu.parallel.scaling", "analytic_dp_projection"): (
        "analytic_dp_projection",
        ["config", "counts", "step_s", "bw_b_s", "grad_dtype_bytes",
         "overlap"],
        "the link rate is an argument (the measured NVLINK_ALLREDUCE_B_S), "
        "not JAX's TPU ICI / DCN constants"),
    ("gasr_tpu.runtime.checkpoint", "save_params_orbax"): (
        "save_params_dcp", ["path", "params", "specs", "mesh"],
        "the sharded checkpoint is torch.distributed.checkpoint's, each "
        "rank writing its shards per `specs` on `mesh`"),
    ("gasr_tpu.runtime.checkpoint", "load_params_orbax"): (
        "load_params_dcp", ["path", "like", "specs", "mesh"],
        "the sharded checkpoint is torch.distributed.checkpoint's"),
    ("gasr_tpu.train", "make_sharded_train_step"): (
        "make_sharded_train_step", ["config", "mesh", "optimizer", "params"],
        "every rank gets the whole params tree (by default model_init from "
        "config.seed on the CPU) and keeps its shards; JAX draws them from "
        "`key` inside one program"),
}

# (module, JAX name) -> reason
REMOVED = {
    ("gasr_tpu.runtime.profiler", "Speedometer"):
        "no program code, benchmark or documented use read it; the "
        "benchmark's end-to-end metrics take its place",
    ("gasr_tpu.runtime.profiler", "profile_fn"):
        "no program code, benchmark or documented use read it; the "
        "port's profiler records spans instead",
}


# port module (or package, with every module under it) -> reason it has no
# counterpart in `gasr_tpu`
PORT_ONLY = {
    "gasr_tpu_torch.ops.cuda":
        "the hand-written CUDA kernels and their loader, in place of "
        "`gasr_tpu/ops/pallas`'s TPU kernels",
    "gasr_tpu_torch.graft_entry":
        "the port's entry points; JAX's are the repo root's "
        "`__graft_entry__.py`, outside the package",
    "gasr_tpu_torch.parallel.checks":
        "rank programs of one process a card, which JAX's single "
        "program over every device does not need",
    "gasr_tpu_torch.parallel.collectives":
        "the tensor-parallel forward's collectives as autograd Functions, "
        "which GSPMD writes for JAX",
    "gasr_tpu_torch.runtime._tree":
        "walking nested containers of tensors, which `jax.tree_util` "
        "does for JAX",
}


def _modules(package):
    root = Path(package.__file__).parent
    for path in sorted(root.rglob("*.py")):
        parts = list(path.relative_to(root.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


MODULES = [name for name in _modules(gasr_tpu)
           if not name.startswith("gasr_tpu.ops.pallas")]


def _public(module):
    """The functions and classes `module` defines, by name."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_")
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


def _params(obj):
    """Parameter names; [] where there is no signature (an exception class
    that keeps BaseException's)."""
    try:
        return [p.name for p in inspect.signature(obj).parameters.values()]
    except ValueError:
        return []


@pytest.mark.parametrize("name", MODULES)
def test_port_module_has_every_public_name_and_signature(name):
    jmod = importlib.import_module(name)
    tmod = importlib.import_module("gasr_tpu_torch" + name[len("gasr_tpu"):])
    for attr, jobj in _public(jmod).items():
        want = [RENAMED.get(p, p) for p in _params(jobj)]
        if (name, attr) in REMOVED:
            assert not hasattr(tmod, attr), (name, attr)
            continue
        if (name, attr) in DEPARTURES:
            port_name, port_params, _ = DEPARTURES[(name, attr)]
            assert _params(getattr(tmod, port_name)) == port_params, \
                (name, attr)
            continue
        assert hasattr(tmod, attr), f"{name}.{attr} has no counterpart"
        got = [p for p in _params(getattr(tmod, attr))
               if p not in ADDED or p in want]
        assert got == want, f"{name}.{attr}: {got} against JAX's {want}"


def test_departures_are_needed_and_stated():
    """Each departure names a real JAX function or class whose
    counterpart the plain rule would refuse, and gives its reason."""
    for (name, attr), (port_name, port_params, reason) in DEPARTURES.items():
        assert name in MODULES and len(reason) > 20
        jobj = _public(importlib.import_module(name))[attr]
        want = [RENAMED.get(p, p) for p in _params(jobj)]
        plain = [p for p in port_params if p not in ADDED or p in want]
        assert port_name != attr or plain != want, (name, attr)
    listed = " ".join(str(v) for v in DEPARTURES.values())
    assert "topk_impl" not in listed
    for (name, attr), reason in REMOVED.items():
        assert name in MODULES and len(reason) > 20
        assert attr in _public(importlib.import_module(name)), (name, attr)


def _port_only(name):
    return next((k for k in PORT_ONLY
                 if name == k or name.startswith(k + ".")), None)


def test_every_port_module_has_a_counterpart_or_a_stated_reason():
    jax_names = set(_modules(gasr_tpu))
    port = list(_modules(gasr_tpu_torch))
    for name in port:
        if _port_only(name) is None:
            assert "gasr_tpu" + name[len("gasr_tpu_torch"):] in jax_names, \
                f"{name} has no counterpart in gasr_tpu and no stated reason"
    # each entry is needed: it covers a port module, and has no counterpart
    for key, reason in PORT_ONLY.items():
        assert len(reason) > 20 and any(_port_only(n) == key for n in port)
        assert "gasr_tpu" + key[len("gasr_tpu_torch"):] not in jax_names, key
