"""The exchange protocol of `tp_scan` around a toy body.

`toy_exchange_scan` replaces
`gasr_tpu/ops/pallas/exchange_probe.py::toy_exchange_scan` (`_toy_kernel`,
`:45-122`): the same publish / wait / merge code as the whole-scan
vocab-sharded decode kernel (`csrc/exchange.cuh`), around a body that
needs no decoder. Per step t and row r, shard s folds the carry (owned by
shard 0 only, `:65-72`) into the step's local keys, exchanges its sorted
top-128 list with every peer and folds the union; the fold is the step's
output on every shard and the next step's carry, so any parity or
ordering fault corrupts later steps. All n shards run on the keys'
device, as the n virtual devices of JAX's test do.

For CUDA tensors `toy_exchange_scan` launches the kernel
(`csrc/exchange_probe.cu`) and for CPU tensors runs
`toy_exchange_scan_plain`; `toy_exchange_oracle` is the port's own copy of
`exchange_probe.selfcheck`'s numpy oracle (`:195-217`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gasr_tpu_torch.ops.cuda import _lib

S = 128                       # keys a row
INT_MIN = -2 ** 31
CARRY_ID = 1 << 20            # tie ids of the carry's entries: 2^20 + lane

# kernel launches made by toy_exchange_scan
toy_exchange_launches = 0


def _top(k: torch.Tensor, g: torch.Tensor, m: int):
    """(k, g) of the m largest pairs along the last dim under (k desc, g
    asc): one int64 key k * 2^32 + (2^32 - 1 - g) per pair, sorted."""
    packed = k.long() * 2 ** 32 + (2 ** 32 - 1 - g.long())
    top = torch.sort(packed, dim=-1, descending=True).values[..., :m]
    return (torch.div(top, 2 ** 32, rounding_mode="floor"),
            2 ** 32 - 1 - torch.remainder(top, 2 ** 32))


def toy_exchange_scan_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version. keys [n, T, Bt, 128] int32 (each row sorted
    descending) -> [n, T, Bt, 128] int32: every shard's fold per step."""
    _, T, Bt, _ = keys.shape
    dev = keys.device
    lane = torch.arange(S, device=dev).expand(Bt, S)
    carry = torch.full((Bt, S), INT_MIN, dtype=torch.int64, device=dev)
    out = torch.empty(T, Bt, S, dtype=torch.int64, device=dev)
    for t in range(T):
        lists = []
        for s in range(n):
            ck = carry if s == 0 else torch.full_like(carry, INT_MIN)
            lists.append(_top(torch.cat([keys[s, t].long(), ck], -1),
                              torch.cat([s * S + lane, CARRY_ID + lane], -1),
                              S))
        carry, _ = _top(torch.cat([k for k, _ in lists], -1),
                        torch.cat([g for _, g in lists], -1), S)
        out[t] = carry
    return out.to(torch.int32).unsqueeze(0).expand(n, -1, -1, -1).clone()


def toy_exchange_oracle(keys: np.ndarray) -> np.ndarray:
    """numpy oracle (a copy of `exchange_probe.selfcheck`'s): the global
    (key desc, id asc) top-128 of the union of the n local lists and the
    shard-0-owned carry, per step. keys [n, T, Bt, 128] -> [T, Bt, 128].
    Local top-128 truncation before the exchange cannot drop a global
    top-128 element (any pool contributes <= 128 of them), so the full
    union's sort equals the kernel's truncated fold."""
    n, T, Bt, _ = keys.shape
    lane = np.arange(S)
    carry_k = np.full((Bt, S), np.int64(INT_MIN), np.int64)
    carry_g = np.broadcast_to(CARRY_ID + lane, (Bt, S))
    out = np.empty((T, Bt, S), np.int64)
    for t in range(T):
        uk = [keys[d, t].astype(np.int64) for d in range(n)]
        ug = [np.broadcast_to(d * S + lane, (Bt, S)) for d in range(n)]
        uk.append(carry_k)
        ug.append(carry_g)
        uk = np.concatenate(uk, -1)
        ug = np.concatenate(ug, -1)
        for b in range(Bt):
            order = np.lexsort((ug[b], -uk[b]))[:S]
            out[t, b] = uk[b][order]
        carry_k = out[t].copy()
    return out


def toy_exchange_scan(keys: torch.Tensor, n: int) -> torch.Tensor:
    """keys [n, T, Bt, 128] int32, shard s's keys at keys[s], each row
    sorted descending -> [n, T, Bt, 128] int32, shard s's fold per step
    (equal on every shard). On the card: one cooperative launch of n x G
    one-warp blocks (G: as many as the card holds at once, at most Bt);
    a grid that cannot be resident raises."""
    if keys.device.type == "cpu":
        return toy_exchange_scan_plain(keys, n)
    if keys.device.type != "cuda":
        raise ValueError(f"toy_exchange_scan: unsupported device "
                         f"{keys.device}")
    if keys.ndim != 4 or keys.shape[0] != n or keys.shape[3] != S or \
            keys.dtype != torch.int32 or n < 1:
        raise ValueError(f"toy_exchange_scan: keys must be int32 "
                         f"[n={n}, T, Bt, {S}], got {keys.dtype} "
                         f"{list(keys.shape)}")
    _, T, Bt, _ = keys.shape
    dev = keys.device
    keys = keys.contiguous()
    out = torch.empty_like(keys)
    if T * Bt == 0:
        return out
    lib = _lib.load("exchange_probe")
    cap = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _lib.check(lib.toy_exchange_capacity(ctypes.byref(cap)),
                   "toy_exchange_capacity")
    G = min(Bt, cap.value // n)
    if G < 1:
        raise ValueError(f"toy_exchange_scan: {n} shards cannot be resident "
                         f"at once on {dev}, which holds {cap.value} blocks")
    outbox = torch.empty(n, 2, G, S, dtype=torch.int64, device=dev)
    flags = torch.zeros(n, G, dtype=torch.int32, device=dev)
    box_tbl = torch.tensor([b.data_ptr() for b in outbox], dtype=torch.int64,
                           device=dev)
    flag_tbl = torch.tensor([f.data_ptr() for f in flags], dtype=torch.int64,
                            device=dev)
    with torch.cuda.device(dev):
        err = lib.toy_exchange_launch(_lib.ptr(keys), T, Bt, n, G,
                                      _lib.ptr(box_tbl), _lib.ptr(flag_tbl),
                                      _lib.ptr(out), _lib.stream(dev))
    _lib.check(err, f"toy_exchange_scan ({n} shards x {G} blocks)")
    global toy_exchange_launches
    toy_exchange_launches += 1
    return out
