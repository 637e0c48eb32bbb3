"""Checkpoints and the weights bridge from the JAX package.

Params are nested dicts and lists of tensors with the JAX package's
names and layouts: linear weights are `[in, out]` and RNN weights
`w_ih [in, H]`, `w_hh [H, H]` (the reference's convention, the
transpose of `torch.nn.Linear` / `torch.nn.RNN`). The port computes
`x @ w` on that layout directly, so the bridge copies arrays and
transposes nothing.

The flat key scheme is the JAX package's `save_params` npz: nested keys
joined with "/", list indices as decimal path parts
(`mlp1/w`, `rnn/layers/0/w_hh`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list of tensors or arrays -> {"a/b/0/c": ndarray}."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(flatten_params(v, f"{prefix}{i}/"))
    elif isinstance(params, torch.Tensor):
        flat[prefix[:-1]] = params.detach().cpu().numpy()
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


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
