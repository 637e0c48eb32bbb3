"""Plain CTC prefix beam search in the log domain, batched, in PyTorch: a
frozen copy of the algorithm the program's decoder states (the matched
merge), written out frame by frame.

Per frame, each of the W beam slots holds a collapsed prefix with
(p_blank, p_nonblank). Every slot offers one "stay" candidate (a blank,
a repeat of its last symbol, and the extend of the slot whose prefix
plus this slot's last symbol is this slot's prefix, absorbed here) and
V-1 extends (not blank; an extend whose prefix already has a slot is
left out). The next beam is the W best candidates, score descending,
then candidate index (slot * V + symbol) ascending, on the total order
of the float bits (-0.0 below +0.0). Prefix identity is a pair of 32-bit
rolling hashes with the length folded into the second; log-add-exp
drops a term below e^-80 of the other. Tokens are rebuilt from
per-frame backpointers at every frame the caller asks for.

`decode(log_probs, W, snapshots=[t...])` returns, at each snapshot (a
frame count), each utterance's best prefix (a token list) and its score.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

NEG_INF = -1.0e30
DEAD = -3.0e38
H_SEED = 2166136261
M1, M2 = 1000003, 16777619
MASK32 = 0xFFFFFFFF


def _lae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return m + torch.log1p(torch.exp(torch.clamp_min(lo - m, -80.0)) *
                           (lo - m > -80.0))


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys whose order is (value desc, index asc)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mono = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    return (mono << 31) | ((1 << 31) - 1 - idx)


def _top(x: torch.Tensor, k: int):
    keys = torch.sort(_order_keys(x), dim=-1, descending=True).values[:, :k]
    idx = (1 << 31) - 1 - (keys & ((1 << 31) - 1))
    return torch.gather(x, 1, idx), idx


def _init(B: int, W: int, dev) -> Dict[str, torch.Tensor]:
    slot = torch.arange(W, device=dev)
    first = (slot == 0).expand(B, W)
    z = torch.zeros(B, W, dtype=torch.int64, device=dev)
    return {"h1": torch.where(first, H_SEED, 0).to(torch.int64),
            "h2": torch.where(first, H_SEED, slot.expand(B, W)).to(
                torch.int64),
            "hp1": z, "hp2": z.clone(), "last": z - 1, "length": z.clone(),
            "live": first.clone(),
            "pb": torch.where(first, 0.0, NEG_INF).float(),
            "pnb": torch.full((B, W), NEG_INF, device=dev)}


def _frame(s: Dict[str, torch.Tensor], f: torch.Tensor, blank: int):
    """One frame: (state, f [B, V]) -> (state', (parent, symbol,
    appended) [B, W] each)."""
    B, W = s["pb"].shape
    V = f.shape[1]
    dev = f.device
    pb, pnb, live, last, length = (s["pb"], s["pnb"], s["live"], s["last"],
                                   s["length"])
    total = _lae(pb, pnb)
    last_c = last.clamp(0, V - 1)
    f_last = torch.gather(f, 1, last_c)
    k2 = (s["h2"] * 31 + length) & MASK32
    kp2 = (s["hp2"] * 31 + (length - 1)) & MASK32
    eq = ((s["h1"][:, :, None] == s["hp1"][:, None, :])
          & (k2[:, :, None] == kp2[:, None, :])
          & live[:, :, None] & live[:, None, :])
    has = eq.any(dim=1)
    match = eq.to(torch.int32).argmax(dim=1)
    stay_pb = total + f[:, blank:blank + 1]
    stay_pnb = torch.where(length > 0, pnb + f_last, NEG_INF)
    pb_m, pnb_m = torch.gather(pb, 1, match), torch.gather(pnb, 1, match)
    base_m = torch.where(torch.gather(last, 1, match) == last, pb_m,
                         _lae(pb_m, pnb_m))
    stay_pnb = _lae(stay_pnb, torch.where(has, base_m + f_last, NEG_INF))
    stay = torch.where(live, _lae(stay_pb, stay_pnb), DEAD)
    vs = torch.arange(V, device=dev)
    ext = torch.where(vs[None, None, :] == last[:, :, None],
                      pb[:, :, None], total[:, :, None]) + f[:, None, :]
    excl = torch.zeros(B, W * V + 1, dtype=torch.bool, device=dev)
    excl.scatter_(1, torch.where(has, match * V + last_c, W * V), True)
    excl = excl[:, :W * V].view(B, W, V)
    ok = (vs != blank)[None, None, :] & live[:, :, None] & ~excl
    cand = torch.where((vs == blank)[None, None, :], stay[:, :, None],
                       torch.where(ok, ext, DEAD))
    vals, idx = _top(cand.reshape(B, W * V), W)
    w, v = idx // V, idx % V
    is_stay = v == blank
    nlive = vals > DEAD * 0.5

    def g(x):
        return torch.gather(x, 1, w)

    h1, h2 = g(s["h1"]), g(s["h2"])
    sym = torch.where(is_stay, g(last), v)
    sel_ext = torch.gather(ext.reshape(B, W * V), 1, idx)
    ns = {"h1": torch.where(is_stay, h1, (h1 * M1 + v + 1) & MASK32),
          "h2": torch.where(is_stay, h2, (h2 * M2 + v + 1) & MASK32),
          "hp1": torch.where(is_stay, g(s["hp1"]), h1),
          "hp2": torch.where(is_stay, g(s["hp2"]), h2),
          "last": sym, "length": g(length) + (~is_stay).long(),
          "live": nlive,
          "pb": torch.where(nlive & is_stay, g(stay_pb), NEG_INF),
          "pnb": torch.where(nlive, torch.where(is_stay, g(stay_pnb),
                                                sel_ext), NEG_INF)}
    return ns, (w, sym, (~is_stay) & nlive)


def _best(s: Dict[str, torch.Tensor], back: List, max_len: int
          ) -> List[Tuple[List[int], float]]:
    """Slot 0 (the best) of every utterance: its tokens, walked back
    through the backpointers, and its score."""
    B = s["pb"].shape[0]
    dev = s["pb"].device
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    toks = []
    for parent, sym, app in reversed(back):
        toks.append(torch.where(app[rows, cur], sym[rows, cur], -1))
        cur = parent[rows, cur]
    toks = torch.stack(toks[::-1], dim=1).cpu().tolist() if toks else \
        [[] for _ in range(B)]
    score = torch.where(s["live"][:, 0], _lae(s["pb"], s["pnb"])[:, 0],
                        NEG_INF).cpu().tolist()
    out = []
    for b in range(B):
        seq = [t for t in toks[b] if t >= 0][:max_len]
        out.append((seq, score[b]))
    return out


def pad_blank(log_probs: torch.Tensor, lengths: Optional[torch.Tensor],
              blank: int) -> torch.Tensor:
    """log_probs [T, B, V] with every frame t >= lengths[b] a certain
    blank (0 for blank, NEG_INF elsewhere); as it is without lengths."""
    if lengths is None:
        return log_probs
    T, _, V = log_probs.shape
    dev = log_probs.device
    past = torch.arange(T, device=dev)[:, None] >= lengths.to(dev)[None, :]
    certain = torch.full((V,), NEG_INF, device=dev)
    certain[blank] = 0.0
    return torch.where(past[:, :, None], certain, log_probs)


def decode(log_probs: torch.Tensor, beam_width: int,
           snapshots: Sequence[int], blank_id: int = 0, max_len: int = 256
           ) -> Dict[int, List[Tuple[List[int], float]]]:
    """log_probs [T, B, V] float32 -> {t: [(tokens, score)] * B} for each
    frame count t in `snapshots` (1 <= t <= T)."""
    T, B, _ = log_probs.shape
    s = _init(B, beam_width, log_probs.device)
    back, out = [], {}
    want = set(snapshots)
    for t in range(T):
        s, bp = _frame(s, log_probs[t], blank_id)
        back.append(bp)
        if t + 1 in want:
            out[t + 1] = _best(s, back, max_len)
    return out
