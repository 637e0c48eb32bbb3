"""Checkpoints (npz save / load) and the weights bridge from the JAX
package.

Params are nested dicts and lists of tensors with the JAX package's
names and layouts: linear weights are `[in, out]` and RNN weights
`w_ih [in, H]`, `w_hh [H, H]` (the reference's convention, the
transpose of `torch.nn.Linear` / `torch.nn.RNN`). The port computes
`x @ w` on that layout directly, so the bridge copies arrays and
transposes nothing.

The flat key scheme is the JAX package's `save_params` npz: nested keys
joined with "/", list indices as decimal path parts
(`mlp1/w`, `rnn/layers/0/w_hh`), so that each framework reads the
other's files. The JAX package's Orbax path (`save_params_orbax` /
`load_params_orbax`, each host writing its shards) becomes
`save_params_dcp` / `load_params_dcp` on `torch.distributed.checkpoint`,
under the same keys.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from gasr_tpu_torch.runtime._tree import tree_map


def flat_leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict/list -> {"a/b/0/c": leaf}, the leaves as they are."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            flat.update(flat_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flat_leaves(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = tree
    return flat


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list of tensors or arrays -> {"a/b/0/c": ndarray}."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in flat_leaves(params, prefix).items()}


def unflatten_params(flat: Mapping[str, Any]) -> Any:
    """Inverse of flatten_params: a path part made of digits is a list
    index, any other part a dict key."""
    root: Dict[str, Any] = {}
    for key in flat:
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            idx = sorted(int(k) for k in out)
            if idx != list(range(len(idx))):
                raise ValueError(f"list indices {idx} are not 0..n-1")
            return [out[str(i)] for i in idx]
        return out

    return listify(root)


def save_params(path: str, params: Any) -> None:
    """Write `params` (nested dicts / lists of tensors, arrays or numbers)
    as the JAX package's flat npz (`checkpoint.py::save_params`)."""
    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str, like: Any) -> Any:
    """Read an npz written by either framework's `save_params` into the
    structure of `like` (the names must match): each leaf a tensor with
    the file's dtype and values, on the device of `like`'s leaf (the CPU
    where that leaf is not a tensor)."""
    with np.load(path) as data:
        flat = dict(data)

    def leaf(arr, template):
        dev = (template.device if isinstance(template, torch.Tensor)
               else torch.device("cpu"))
        return torch.from_numpy(np.array(arr)).to(dev)

    return tree_map(leaf, unflatten_like(like, flat), like)


# ---------------- sharded checkpoints (torch.distributed.checkpoint) ------

# torch.distributed.checkpoint and DTensor are imported where the sharded
# functions run: importing them costs about a second, which every user of
# the npz functions would pay

def _placements(spec, mesh):
    from torch.distributed.tensor import Replicate, Shard
    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return [Shard(dims[name]) if name in dims else Replicate()
            for name in mesh.mesh_dim_names]


def _dtensors(params: Any, specs: Any, mesh) -> Dict[str, Any]:
    from torch.distributed.tensor import DTensor
    # each rank's shard goes in as its part of one global tensor (DCP
    # takes a plain tensor as replicated: the ranks' shards would
    # overwrite one another under one key)
    return flat_leaves(tree_map(
        lambda t, s: DTensor.from_local(t.detach(), mesh,
                                        _placements(s, mesh),
                                        run_check=False), params, specs))


def save_params_dcp(path: str, params: Any, specs: Any, mesh) -> None:
    """The sharded checkpoint, the counterpart of the JAX package's
    `save_params_orbax`: every rank of `mesh` (a DeviceMesh) calls it with
    its shards of `params` per `specs` (`parallel/sharding.py`), and each
    writes its part into the directory `path` with
    `torch.distributed.checkpoint`; replicated leaves are written once.
    The keys are `save_params`' ("mlp1/w", "rnn/layers/0/w_hh")."""
    import torch.distributed.checkpoint as dcp
    dcp.save(_dtensors(params, specs, mesh),
             checkpoint_id=os.path.abspath(path))


def load_params_dcp(path: str, like: Any, specs: Any = None,
                    mesh=None) -> Any:
    """Read a `save_params_dcp` directory into the structure of `like`,
    the counterpart of `load_params_orbax`. With `mesh` and `specs`, every
    rank of `mesh` calls it with `like` holding its shards of the layout
    it wants, and gets its shards back: the mesh may differ from the one
    that saved (DCP re-shards). Without them, in one process with no
    process group, `like` holds whole tensors and so does the result.
    Leaves keep `like`'s devices and dtypes."""
    import torch.distributed.checkpoint as dcp
    if mesh is None:
        state = {k: v.detach().clone() for k, v in flat_leaves(like).items()}
        dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=True)
        out = state
    else:
        state = _dtensors(tree_map(lambda t: t.detach().clone(), like),
                          specs, mesh)
        dcp.load(state, checkpoint_id=os.path.abspath(path))
        out = {k: v.to_local() for k, v in state.items()}
    return unflatten_like(like, out)


def unflatten_like(like: Any, flat: Mapping[str, Any], prefix: str = ""):
    """The leaves of `flat` (keys as `flat_leaves` makes them) in the
    structure of `like`."""
    if isinstance(like, Mapping):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [unflatten_like(v, flat, f"{prefix}{i}/")
               for i, v in enumerate(like)]
        return tuple(out) if isinstance(like, tuple) else out
    return flat[prefix[:-1]]


def params_from_jax(tree: Any, device="cpu") -> Any:
    """The JAX package's params -> the port's params (float32 tensors).

    `tree` is either the nested dict/list pytree after `jax.device_get`
    (numpy leaves), or the flat `save_params` npz (an `np.load` result
    or any mapping whose keys contain "/").
    """
    if isinstance(tree, Mapping) and any("/" in k for k in tree):
        tree = unflatten_params(tree)
    return _to_torch(tree, torch.device(device))


def _to_torch(node: Any, device: torch.device) -> Any:
    if isinstance(node, Mapping):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, device) for v in node]
    # a copy: arrays from jax.device_get are read-only
    return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)


# ---------------- PyTorch import ----------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().numpy() if hasattr(v, "detach")
            else np.asarray(v)).astype(np.float32)


def _t(v, device) -> torch.Tensor:
    """A reference weight [out, in] -> the port's [in, out]."""
    return torch.from_numpy(np.ascontiguousarray(_np(v).T)).to(device)


def _v(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(v))).to(device)


def import_torch_deepspeech(state_dict: Mapping[str, Any],
                            num_layers: int = 1,
                            bidirectional: bool = False,
                            device="cpu") -> dict:
    """The reference's DeepSpeech state_dict (baseline/model.py: mlp123,
    rnn, mlp56) -> the port's params.

    torch Linear stores weight [out, in]; the port stores [in, out]
    (reference convention, Linear.h:21). torch RNN stores weight_ih_l{l}
    [H, in]; the port stores [in, H] (RNN_Cell.h:21-24). Values may be
    tensors or array-likes."""
    sd = state_dict
    dev = torch.device(device)

    def lin(wk: str, bk: str) -> dict:
        return {"w": _t(sd[wk], dev), "b": _v(sd[bk], dev)}

    def cell(l: int, suffix: str) -> dict:
        return {"w_ih": _t(sd[f"rnn.weight_ih_l{l}{suffix}"], dev),
                "w_hh": _t(sd[f"rnn.weight_hh_l{l}{suffix}"], dev),
                "b_ih": _v(sd[f"rnn.bias_ih_l{l}{suffix}"], dev),
                "b_hh": _v(sd[f"rnn.bias_hh_l{l}{suffix}"], dev)}

    rnn = {"layers": [cell(l, "") for l in range(num_layers)]}
    if bidirectional:
        rnn["layers_rev"] = [cell(l, "_reverse") for l in range(num_layers)]
    return {
        "mlp1": lin("mlp123.0.weight", "mlp123.0.bias"),
        "mlp2": lin("mlp123.2.weight", "mlp123.2.bias"),
        "mlp3": lin("mlp123.4.weight", "mlp123.4.bias"),
        "rnn": rnn,
        "mlp5": lin("mlp56.0.weight", "mlp56.0.bias"),
        "mlp6": lin("mlp56.2.weight", "mlp56.2.bias"),
    }


def import_torch_lstm(state_dict: Mapping[str, Any], num_layers: int = 1,
                      bidirectional: bool = False, prefix: str = "",
                      device="cpu") -> dict:
    """A torch.nn.LSTM state_dict -> the port's `ops/lstm.py` params
    (gate order i, f, g, o kept; weights transposed to [in, 4H])."""
    sd = state_dict
    dev = torch.device(device)

    def cell(l: int, suffix: str) -> dict:
        return {"w_ih": _t(sd[f"{prefix}weight_ih_l{l}{suffix}"], dev),
                "w_hh": _t(sd[f"{prefix}weight_hh_l{l}{suffix}"], dev),
                "b_ih": _v(sd[f"{prefix}bias_ih_l{l}{suffix}"], dev),
                "b_hh": _v(sd[f"{prefix}bias_hh_l{l}{suffix}"], dev)}

    params = {"layers": [cell(l, "") for l in range(num_layers)]}
    if bidirectional:
        params["layers_rev"] = [cell(l, "_reverse")
                                for l in range(num_layers)]
    return params
