"""The exchange of `tp_scan` around a toy body.

`toy_exchange_scan` replaces
`gasr_tpu/ops/pallas/exchange_probe.py::toy_exchange_scan` (`_toy_kernel`,
`:45-122`): the same exchange and merge as the whole-scan vocab-sharded
decode kernel (`csrc/exchange.cuh`), in both its transports, around a
body that needs no decoder. Per step t and row r, shard s folds the carry
(owned by shard 0 only, `:65-72`) into the step's local keys, exchanges
its sorted top-128 list with every peer and merges the union; the merge
is the step's output on every shard and the next step's carry, so any
parity or ordering fault corrupts later steps. The shards run on the
keys' device, as the n virtual devices of JAX's test do, or one a card
of `devices`.

For CUDA tensors `toy_exchange_scan` launches the kernel
(`csrc/exchange_probe.cu`): the cluster transport where every shard sits
on one card and n fits a cluster, the push transport otherwise (or as
`design` asks); for CPU tensors it runs `toy_exchange_scan_plain`.
`toy_exchange_oracle` is the port's own copy of
`exchange_probe.selfcheck`'s numpy oracle (`:195-217`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gasr_tpu_torch.ops.cuda import _lib, fused_decode

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


def toy_cluster_limit(device) -> int:
    """The largest toy cluster (at most 16 one-warp blocks) `device`
    holds."""
    c = ctypes.c_int(0)
    with torch.cuda.device(device):
        _lib.check(_lib.load("exchange_probe").toy_cluster_limit(
            ctypes.byref(c)), "toy_cluster_limit")
    return c.value


def toy_exchange_scan(keys: torch.Tensor, n: int, devices=None,
                      design: str = None) -> torch.Tensor:
    """keys [n, T, Bt, 128] int32, shard s's keys at keys[s], each row
    sorted descending -> [n, T, Bt, 128] int32, shard s's merge per step
    (equal on every shard), on the keys' device. devices: the shards' cards
    (default: every shard on the keys' device). On the card: the cluster
    transport (one launch of Bt clusters of n one-warp blocks) where every
    shard sits on one card and n <= `toy_cluster_limit`, else the push
    transport (one cooperative launch a card of its shards x G one-warp
    blocks, G: as many as every card holds at once, at most Bt; a grid
    that cannot be resident raises); `design` ("cluster" / "push") asks for
    one, which the placement must admit."""
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
    dev = keys.device
    devices = [dev] * n if devices is None else \
        [torch.device(d) for d in devices]
    if len(devices) != n or {d.type for d in devices} != {"cuda"}:
        raise ValueError(f"toy_exchange_scan: {n} CUDA devices expected, "
                         f"got {devices}")
    cards = list(dict.fromkeys(devices))
    fits = len(cards) == 1 and n <= toy_cluster_limit(cards[0])
    if design is None:
        design = "cluster" if fits else "push"
    elif design not in ("cluster", "push") or (design == "cluster"
                                               and not fits):
        raise ValueError(f"toy_exchange_scan: design {design!r} does not "
                         f"admit {n} shards on {len(cards)} card(s)")
    _, T, Bt, _ = keys.shape
    keys = keys.contiguous()
    out = torch.empty_like(keys)
    if T * Bt == 0:
        return out
    lib = _lib.load("exchange_probe")
    global toy_exchange_launches
    if design == "cluster":
        k = keys.to(cards[0])
        o = torch.empty_like(k)
        with torch.cuda.device(cards[0]):
            err = lib.toy_cluster_launch(k.data_ptr(), T, Bt, n,
                                         o.data_ptr(), _lib.stream(cards[0]))
        _lib.check(err, f"toy_exchange_scan ({Bt} clusters of {n} blocks)")
        toy_exchange_launches += 1
        return o.to(dev)
    local = {d: [s for s in range(n) if devices[s] == d] for d in cards}
    cap = {}
    for d in cards:
        c = ctypes.c_int(0)
        with torch.cuda.device(d):
            _lib.check(lib.toy_push_capacity(n, ctypes.byref(c)),
                       "toy_push_capacity")
        cap[d] = c.value
    G = min(Bt, min(cap[d] // len(local[d]) for d in cards))
    if G < 1:
        raise ValueError(f"toy_exchange_scan: {n} shards cannot be resident "
                         f"at once on {[str(d) for d in cards]}, which hold "
                         f"{list(cap.values())} blocks")
    inbox = fused_decode.push_inboxes(devices, G, 2 * S)
    runs = []
    for d in cards:
        k = keys.to(d)
        shards = torch.tensor(local[d], dtype=torch.int32, device=d)
        tbl = torch.tensor([b.data_ptr() for b in inbox], dtype=torch.int64,
                           device=d)
        o = torch.empty(len(local[d]), T, Bt, S, dtype=torch.int32, device=d)
        runs.append((d, k, shards, tbl, o))
    for d, k, shards, tbl, o in runs:
        with torch.cuda.device(d):
            err = lib.toy_push_launch(k.data_ptr(), T, Bt, n,
                                      shards.data_ptr(), len(local[d]), G,
                                      tbl.data_ptr(), o.data_ptr(),
                                      _lib.stream(d))
        _lib.check(err, f"toy_exchange_scan ({len(local[d])} shards x {G} "
                        f"blocks on {d})")
        toy_exchange_launches += 1
    if len(cards) > 1:
        for d in cards:                    # peers may still write inboxes
            torch.cuda.synchronize(d)
    for d, _, _, _, o in runs:
        for i, s in enumerate(local[d]):
            out[s] = o[i].to(dev)
    return out
