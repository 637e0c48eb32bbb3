"""A closed loop of training steps (`train.make_train_step`) on a pool of
"pool" batches of "batch" utterances. With "min_frames", the utterances
are from "min_frames" to "frames" long (a length bucket), zero past
their ends, and the loss takes their lengths; each transcript has
round(seconds x rate) labels, uniform in [1, V], the rates spread over
"tokens_per_s".

Set-up drives the step through its first three steps on three
different batches and reads, from the optimizer's state, the first
gradient and each leaf's change. In the window, before each step that
may be the last, the parameters and the AdamW moments are copied aside,
so that the window's last step is judged from the state it began with;
every step's loss is kept.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from asrbench import judge, reference
from asrbench import weights as wmod
from asrbench.common import (FRAME_S, features, generator, lengths, pad_past,
                             program_config, spread_set)
from asrbench.loops._base import Loop


def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    if hasattr(torch, "_foreach_copy_"):
        torch._foreach_copy_(dst, src)
    else:
        for d, s in zip(dst, src):
            d.copy_(s)


def make_pool(cell, cfg, gen, device) -> List[Dict[str, torch.Tensor]]:
    """The mix's "pool" batches of "batch" utterances, drawn from `gen`:
    inputs zero past each utterance's end, labels, and the lengths the
    loss takes."""
    t = cell.traffic
    B, T, n = t["batch"], t["frames"], t["pool"]
    fam = reference.family(cell.config["family"])
    xs = features(gen, n, B, T, cfg.feat_size, device)
    lens = lengths(t, gen, n, B, device) or [
        torch.full((B,), T, dtype=torch.int32, device=device)] * n
    lo, hi = t["tokens_per_s"]
    rates = spread_set(gen, n * B, lo, hi, device)
    max_labels = int(T * FRAME_S * hi + 1)
    pool = []
    for k, (x, ln) in enumerate(zip(xs, lens)):
        pad_past(x, ln)
        secs = ln.double().cpu() * FRAME_S
        n_lab = (secs * rates[k * B:(k + 1) * B]).round().clamp(min=1)
        pool.append({
            "inputs": x,
            "labels": torch.randint(1, cfg.vocab_size + 1, (B, max_labels),
                                    generator=gen, device=device,
                                    dtype=torch.int32),
            "input_lengths": torch.tensor(
                [fam.output_frames(int(v)) for v in ln.tolist()],
                dtype=torch.int32, device=device),
            "label_lengths": n_lab.to(torch.int32).to(device)})
    return pool


class Load(Loop):
    PRECISION = "train"
    SPANS = ("forward", "ctc", "backward", "optimizer")
    NEAR_END = True
    # the phases the step's `mark` ends after "forward", and the spans read
    # between two marks: (span, from, to)
    PHASES = ("ctc", "backward", "optimizer")
    MARK_SPANS = (("ctc_train", "forward", "ctc"),
                  ("backward_train", "ctc", "backward"))

    def __init__(self, cell, params, seed: int, device: str, spans):
        from gasr_tpu_torch.train import make_optimizer, make_train_step
        t = cell.traffic
        self.cell = cell
        self.cfg = cfg = program_config(cell, device)
        self.B, self.T = t["batch"], t["frames"]
        self.pool = make_pool(cell, cfg, generator(seed, 2, device), device)
        opt = cell.config["optimizer"]
        self.optimizer = make_optimizer(opt["learning_rate"],
                                        opt["weight_decay"])
        self.params, self.spans = params, spans
        self.leaves = [p for _, p in wmod.leaves(params)]
        self.start = [p.detach().clone() for p in self.leaves]
        self.opt_state = self.optimizer.init(params)
        self.step = make_train_step(cfg, self.optimizer,
                                    compute_dtype=cfg.compute_dtype)
        self.readings: Dict[str, torch.Tensor] = {}
        self.losses: List[torch.Tensor] = []
        self.snap: Optional[Dict] = None
        self.snap_i: Optional[int] = None
        self.final: Optional[Dict] = None

    def _moments(self, key: str) -> List[torch.Tensor]:
        """The AdamW state's `key` of every leaf (zero where a step that
        never updated left none)."""
        st = self.opt_state.state
        return [st[p][key] if key in st.get(p, {}) else torch.zeros_like(p)
                for p in self.leaves]

    def warm(self) -> None:
        losses = []
        b1 = self.opt_state.param_groups[0]["betas"][0]
        for i in range(3):
            _, _, m = self.call(i)
            losses.append(m["loss"])
            if i == 0:
                self.readings["grad_norm"] = m["grad_norm"]
                # Adam's first moment after one step is (1 - b1) g
                self.readings["grad_norms"] = torch.stack(
                    [torch.linalg.vector_norm(m_) / (1 - b1)
                     for m_ in self._moments("exp_avg")])
        with torch.no_grad():
            self.readings["update_norms"] = torch.stack(
                [torch.linalg.vector_norm(p - p0)
                 for p, p0 in zip(self.leaves, self.start)])
        self.readings["losses"] = torch.stack(losses)
        # room for the state before the window's last step
        self.snap = {k: [torch.empty_like(p) for p in self.leaves]
                     for k in ("p", "m", "v")}
        self.snap["b1"] = b1

    def near_end(self, i: int) -> None:
        with torch.no_grad():
            _copy(self.snap["p"], self.leaves)
            _copy(self.snap["m"], self._moments("exp_avg"))
            _copy(self.snap["v"], self._moments("exp_avg_sq"))
        step = self.opt_state.state.get(self.leaves[0], {}).get("step", 0)
        self.snap["t"] = torch.as_tensor(step).clone()
        self.snap_i = i

    def call(self, i: int):
        batch = self.pool[i % len(self.pool)]
        if not self.spans.on:
            return self.step(self.params, self.opt_state, batch)
        phases = iter(self.PHASES + (None,))
        rng = [self.spans.range("forward")]
        rng[0].__enter__()
        stamps = []

        def mark(phase):
            rng[0].__exit__(None, None, None)
            if self.spans.cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                stamps.append((phase, ev))
            nxt = next(phases)
            if nxt is not None:
                rng[0] = self.spans.range(nxt)
                rng[0].__enter__()
        out = self.step(self.params, self.opt_state, batch, mark=mark)
        self.spans._events.setdefault("marks", []).append(stamps)
        return out

    def capture(self, i: int, out) -> None:
        self.losses.append(out[2]["loss"])
        if i == self.snap_i:
            self.snap_out = out[2]

    def end_to_end(self, calls: int, window_s: float, latencies) -> Dict:
        return {"train_step_ms": window_s / calls * 1e3}

    def attempted(self, calls: int) -> int:
        return calls

    def after_window(self, spans) -> None:
        """The step's phases (CUDA events at each `mark`) as spans:
        "ctc_train" from the forward's end to the loss's,
        "backward_train" from there to the gradients'."""
        out: Dict[str, List[float]] = {}
        for stamps in spans._events.pop("marks", []):
            ev = dict(stamps)
            for name, a, b in self.MARK_SPANS:
                if a in ev and b in ev:
                    out.setdefault(name, []).append(
                        ev[a].elapsed_time(ev[b]))
        spans.host_s.update({k: [x * 1e-3 for x in v]
                             for k, v in out.items()})

    def drop_program(self) -> None:
        # the last step's outputs stay: the parameters and first moments
        self.final = {"p": self.leaves, "m": self._moments("exp_avg"),
                      "loss": self.snap_out["loss"],
                      "grad_norm": self.snap_out["grad_norm"]}
        self.opt_state = self.step = self.optimizer = None
        self.params = self.leaves = None

    def _state(self) -> Dict:
        s = dict(self.snap)
        s["t"] = int(round(float(s["t"])))
        return s

    def _batches(self):
        return self.pool[:3], self.pool[self.snap_i % len(self.pool)]

    def numbers(self, params):
        conf, prec = self.cell.config, self.precision()
        first, last = self._batches()
        vals, failed = judge.train_numbers(
            conf, wmod.with_leaves(params, self.start), first, self.readings,
            prec)
        state = self._state()
        ref = judge.step_from(conf, params, state, last, prec)
        vals.update(judge.timed_numbers(
            judge.program_step(state, self.final), ref))
        losses = torch.stack(self.losses)
        vals["timed_loss_nonfinite"] = float((~torch.isfinite(losses)).sum())
        vals["timed_step"] = float(self.snap_i + 4)
        return vals, failed

    def _in_place(self, params, precision, rows=None) -> Dict:
        """The numbers with the reference at `precision` (over the first
        `rows` rows of each batch) in the program's place."""
        conf, prec = self.cell.config, self.precision()
        first, last = self._batches()
        params0 = wmod.with_leaves(params, self.start)
        got = judge.reference_steps(conf, params0, first, precision, rows)
        vals, _ = judge.train_numbers(conf, params0, first, got, prec)
        state = self._state()
        ref = judge.step_from(conf, params, state, last, prec)
        vals.update(judge.timed_numbers(
            judge.step_from(conf, params, state, last, precision, rows),
            ref))
        return vals

    def control_numbers(self, params) -> Dict:
        return self._in_place(params, self.precision("control_precision"))

    def fault_numbers(self, params) -> Dict[str, Dict]:
        return {"half_batch": self._in_place(params, self.precision(),
                                             rows=self.B // 2)}
