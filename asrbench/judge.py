"""What decides `correct`: the program's outputs of the window held to
the plain reference (`reference/`), run after the window with the
program's state freed, with TF32 off.

Each loop (`loops/<kind>.py`) picks its numbers from these:
  - serving (the log-probs of the sampled calls, and the transcripts
    each returned):
      lp_gap_t0   max |program - reference| of the first frame's
                  log-probs (before the recurrence's state carries
                  rounding);
      lp_rms      root mean square of program - reference over every
                  log-prob of the sampled calls;
      score_gap   max |program - reference| of the best hypothesis's
                  score, the reference decoding the program's own
                  log-probs (for a stream at every chunk's end; where
                  the utterances have lengths, the frames past each
                  one's end a certain blank, as the program's decode
                  takes them);
      token_miss  transcripts (best hypotheses) whose tokens differ from
                  the reference's on the same log-probs.
  - training (the first three steps, from the optimizer's state):
      grad_norm_gap  (read, not compared) |program - reference| /
                  reference of the first step's global gradient norm
                  before the clip (the step's own "grad_norm");
      grad_gap    the worst leaf's gap between the norms of the first
                  gradient as the optimizer took it (clipped) and the
                  reference's, over the larger of the reference's norm
                  of that leaf and of the median leaf;
      update_gap  the same for the change of the parameters after three
                  steps, leaving out leaves whose reference gradient is
                  under a thousandth of the median leaf's;
    and the window's last step, which the reference takes from the
    state the program began it with (its parameters, AdamW moments and
    step count):
      last_grad_gap    as grad_gap, of that step's gradient as AdamW took
                       it: (m after - b1 m before) / (1 - b1);
      last_update_gap  as update_gap, of that step's change;
      last_grad_norm_gap  as grad_norm_gap, of that step;
      timed_loss_nonfinite  the window's steps whose loss is not finite.
Each number passes when it is at most its limit (`limits/<cell>.json`).
A training run also reads, without comparing them, the first step's
|loss - reference| / |reference| (`loss_gap`), the largest of steps
2-3 (`loss_gap_later`), the last step's (`last_loss_gap`), which step
that was (`timed_step`, counting set-up's three), and `grad_norm_gap`
and `last_grad_norm_gap`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch

from asrbench import reference
from asrbench import weights as wmod
from asrbench.reference import decoder as ref_decoder
from asrbench.reference.precision import round_to
from asrbench.reference.train import AdamW, batch_grads


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forward_fn(conf: Dict, params, precision):
    """The reference forward of the configuration's family
    (`reference/<family>.py`) at `precision`: x [B, T, F] -> log-probs
    [T', B, V+1]."""
    fam = reference.family(conf["family"])
    return lambda x: fam.apply(params, x, conf["model"], precision)


@torch.no_grad()
def reference_log_probs(conf: Dict, params, x: torch.Tensor,
                        precision) -> torch.Tensor:
    f = forward_fn(conf, params, precision)
    rows = conf.get("reference_block_rows", x.shape[0])
    return torch.cat([f(x[s:s + rows]) for s in range(0, x.shape[0], rows)],
                     dim=1)


def _decode_gaps(conf: Dict, lp: torch.Tensor, lists_at: Dict[int, list],
                 lens: Optional[torch.Tensor] = None) -> Tuple[float, int]:
    p = conf["program"]
    blank = p.get("blank_id", 0)
    ref = ref_decoder.decode(ref_decoder.pad_blank(lp, lens, blank),
                             p["beam_width"], sorted(lists_at), blank,
                             p["decode_max_len"])
    gap, miss = 0.0, 0
    for t, lists in lists_at.items():
        for (tok, score), (rtok, rscore) in zip(lists, ref[t]):
            gap = max(gap, abs(float(score) - float(rscore)))
            miss += list(tok) != list(rtok)
    return gap, miss


def serving_numbers(conf: Dict, params, samples, precision,
                    chunk: Optional[int] = None) -> Tuple[Dict, int]:
    """samples: (x, the program's log-probs [T', B, V+1], its
    transcripts: one list a call, or one a chunk with `chunk` frames,
    the utterances' lengths in log-prob frames or None)."""
    t0 = sq = 0.0
    n = 0
    gap, miss = 0.0, 0
    for x, lp, lists, lens in samples:
        lp = lp.float()
        with tf32_off():
            ref = reference_log_probs(conf, params, x, precision)
        d = (lp - ref).double()
        t0 = max(t0, float(d[0].abs().max()))
        sq += float((d * d).sum())
        n += d.numel()
        del ref, d
        T = lp.shape[0]
        at = ({T: lists} if chunk is None else
              {(k + 1) * chunk: part for k, part in enumerate(lists)})
        with tf32_off():
            g, m = _decode_gaps(conf, lp, at, lens)
        gap, miss = max(gap, g), miss + m
    if not n:                          # nothing judged is not correct
        return dict.fromkeys(("lp_gap_t0", "lp_rms", "score_gap",
                              "token_miss"), math.inf), 0
    return ({"lp_gap_t0": t0, "lp_rms": math.sqrt(sq / n),
             "score_gap": gap, "token_miss": float(miss)}, miss)


def reference_steps(conf: Dict, params0, batches: List[Dict], precision,
                    rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Three reference steps from `params0` (left as it is), one on each
    batch: their losses, the per-leaf norms of the first clipped
    gradient and of the first raw one, and of the change after three."""
    start = [p for _, p in wmod.leaves(params0)]
    leaves = [p.detach().clone().requires_grad_(True) for p in start]
    tree = wmod.with_leaves(params0, leaves)
    f = forward_fn(conf, tree, precision)
    opt = AdamW(leaves, conf["optimizer"]["learning_rate"],
                conf["optimizer"]["weight_decay"])
    block = conf.get("reference_block_rows", batches[0]["inputs"].shape[0])
    losses = []
    out: Dict[str, torch.Tensor] = {}
    with tf32_off():
        for i, batch in enumerate(batches[:3]):
            loss, grads = batch_grads(f, leaves, batch, block, rows)
            if i == 0:
                out["raw_grad_norms"] = torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads])
                out["grad_norm"] = _global(out["raw_grad_norms"])
            clipped = opt.step(grads)
            if i == 0:
                out["grad_norms"] = torch.stack(
                    [torch.linalg.vector_norm(g) for g in clipped])
            losses.append(loss)
            del grads, clipped
    with torch.no_grad():
        out["update_norms"] = torch.stack(
            [torch.linalg.vector_norm(p - p0) for p, p0 in zip(leaves,
                                                               start)])
    out["losses"] = torch.stack(losses)
    return out


def _gaps(prog, want, keep=None) -> Optional[torch.Tensor]:
    """Each leaf's |prog - want| over the larger of want and the median
    leaf's want (per-leaf norms); None where a norm is not finite or no
    leaf is kept."""
    prog, want = prog.double().cpu(), want.double().cpu()
    if not (torch.isfinite(prog).all() and torch.isfinite(want).all()):
        return None
    if keep is not None:
        prog, want = prog[keep], want[keep]
    if not want.numel():
        return None
    med = float(want.median())
    return (prog - want).abs() / torch.clamp(want, min=med)


def _worst(prog, want, keep=None) -> float:
    """The worst leaf's gap (`_gaps`)."""
    g = _gaps(prog, want, keep)
    return math.inf if g is None else float(g.max())


def _kept(raw_grad_norms) -> torch.Tensor:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more: the others move under AdamW by round-off alone."""
    g = raw_grad_norms.double().cpu()
    return g >= 1e-3 * float(g.median())


def _global(leaf_norms: torch.Tensor) -> torch.Tensor:
    """The 2-norm of every element together, from the leaves' norms."""
    return torch.linalg.vector_norm(leaf_norms.double())


def _rel(got, want) -> float:
    """|got - want| / |want| of two numbers (inf where got is not
    finite)."""
    g, w = float(got), float(want)
    return abs(g - w) / abs(w) if math.isfinite(g) else math.inf


def train_numbers(conf: Dict, params0, batches, readings: Dict,
                  precision, rows: Optional[int] = None) -> Tuple[Dict, int]:
    ref = reference_steps(conf, params0, batches, precision, rows)
    lp_, lr_ = readings["losses"].double().cpu(), ref["losses"].double().cpu()
    loss_gaps = ((lp_ - lr_).abs() / lr_.abs()).tolist()
    keep = _kept(ref["raw_grad_norms"])
    return ({"loss_gap": loss_gaps[0],
             "grad_norm_gap": _rel(readings["grad_norm"], ref["grad_norm"]),
             "grad_gap": _worst(readings["grad_norms"], ref["grad_norms"]),
             "update_gap": _worst(readings["update_norms"],
                                  ref["update_norms"], keep),
             "loss_gap_later": max(loss_gaps[1:]),
             "leaves_left_out": float((~keep).sum())}, 0)


def _norms(ts) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t) for t in ts])


def step_from(conf: Dict, tree, state: Dict, batch: Dict, precision,
              rows: Optional[int] = None) -> Dict:
    """One reference step on `batch` from `state` (leaves "p", AdamW
    moments "m" and "v" after "t" steps; `tree` gives the leaves'
    places): its loss and the per-leaf norms of its raw and clipped
    gradients and of its change."""
    leaves = [p.detach().clone().requires_grad_(True) for p in state["p"]]
    f = forward_fn(conf, wmod.with_leaves(tree, leaves), precision)
    opt = AdamW(leaves, conf["optimizer"]["learning_rate"],
                conf["optimizer"]["weight_decay"],
                m=[m.clone() for m in state["m"]],
                v=[v.clone() for v in state["v"]], t=state["t"])
    block = conf.get("reference_block_rows", batch["inputs"].shape[0])
    with tf32_off():
        loss, grads = batch_grads(f, leaves, batch, block, rows)
        raw = _norms(grads)
        clipped = opt.step(grads)
    with torch.no_grad():
        out = {"loss": loss.detach(), "raw_grad_norms": raw,
               "grad_norm": _global(raw),
               "grad_norms": _norms(clipped),
               "update_norms": _norms([p - p0 for p, p0 in
                                       zip(leaves, state["p"])])}
    del leaves, opt, grads, clipped
    return out


@torch.no_grad()
def program_step(state: Dict, final: Dict) -> Dict:
    """The norms of the program's step from `state` to `final` (leaves
    "p", first moments "m", "loss"): its gradient as AdamW took it,
    (m after - b1 m before) / (1 - b1), and its change."""
    b1 = state["b1"]
    return {"loss": final["loss"], "grad_norm": final["grad_norm"],
            "grad_norms": _norms([(m1 - b1 * m0) / (1 - b1) for m1, m0 in
                                  zip(final["m"], state["m"])]),
            "update_norms": _norms([p1 - p0 for p1, p0 in
                                    zip(final["p"], state["p"])])}


def timed_numbers(got: Dict, ref: Dict) -> Dict:
    """The last step's numbers: `got` (`program_step`, or a reference in
    the program's place) against the reference (`step_from`)."""
    lg, lr_ = float(got["loss"]), float(ref["loss"])
    keep = _kept(ref["raw_grad_norms"])
    return {"last_grad_norm_gap": _rel(got["grad_norm"], ref["grad_norm"]),
            "last_grad_gap": _worst(got["grad_norms"], ref["grad_norms"]),
            "last_update_gap": _worst(got["update_norms"],
                                      ref["update_norms"], keep),
            "last_loss_gap": (abs(lg - lr_) / abs(lr_)
                              if math.isfinite(lg) else math.inf)}


# read for `PERF.md` (`calibrate.py` prints them), not compared: the
# leaves the update's rule leaves out, which step was the window's last,
# and the losses and global gradient norms, which neither the control nor
# a fault moves to three (ten) times what sound runs read (see PERF.md)
INFO = ("leaves_left_out", "loss_gap", "loss_gap_later", "last_loss_gap",
        "timed_step", "grad_norm_gap", "last_grad_norm_gap")


def judge(cell, vals: Dict, failed: int) -> Tuple[Dict, int, Dict]:
    """({number: {"value", "limit"}}, failed answers, {reading: value}
    of the readings that are not compared), from a loop's numbers."""
    limits = (cell.limits or {}).get("limits", {})
    return ({k: {"value": v, "limit": limits.get(k)}
             for k, v in vals.items() if k not in INFO}, failed,
            {k: v for k, v in vals.items() if k in INFO})


def control_outputs(conf: Dict, params, inputs, precision,
                    chunk: Optional[int] = None) -> List[tuple]:
    """The control, the reference at `precision` in the program's place,
    on `inputs` [(x, lengths in log-prob frames or None)]: its log-probs
    and the transcripts the reference decoder gives on them rounded to
    bf16 (at every chunk's end with `chunk`), as `serving_numbers`
    takes them."""
    p = conf["program"]
    blank = p.get("blank_id", 0)
    out = []
    for x, lens in inputs:
        with tf32_off():
            lp = reference_log_probs(conf, params, x, precision)
            T = lp.shape[0]
            at = [T] if chunk is None else list(range(chunk, T + 1, chunk))
            dec = ref_decoder.decode(
                ref_decoder.pad_blank(round_to(lp, "bf16"), lens, blank),
                p["beam_width"], at, blank, p["decode_max_len"])
        lists = dec[T] if chunk is None else [dec[t] for t in at]
        out.append((x, lp, lists, lens))
    return out

