"""A closed loop of batch transcription calls, each a batch of "batch"
utterances of "frames" frames cycled from a pool of "pool" batches made
at set-up, and each ending with every transcript on the host. With
"min_frames", the utterances of a batch are from "min_frames" to
"frames" long (a length bucket), zero past their ends, and the decode
takes their lengths; otherwise all are "frames" long.

The entry that turns a batch into transcripts is a subclass's
(`transcribe.py`, `stages.py`): `forward(x)` and `decode(lp, p)` of
pool batch p, or a whole `call`.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from asrbench import judge, reference
from asrbench.common import (FRAME_S, features, generator, lengths, pad_past,
                             program_config, sub_seed, untracked)
from asrbench.loops._base import Loop


class BatchLoad(Loop):
    PRECISION = "batch"
    SPANS = ("forward", "decode", "lists")

    def __init__(self, cell, params, seed: int, device: str, spans):
        from gasr_tpu_torch.decoder import ctc_beam_search
        from gasr_tpu_torch.decoder.beam_search import decode_to_lists
        t = cell.traffic
        self.cell, self.params, self.spans = cell, params, spans
        self.cfg = cfg = program_config(cell, device)
        self.B, self.T = t["batch"], t["frames"]
        gen = generator(seed, 2, device)
        self.pool = features(gen, t["pool"], self.B, self.T, cfg.feat_size,
                             device)
        lens = lengths(t, gen, t["pool"], self.B, device)
        fam = reference.family(cell.config["family"])
        self.out_lens: Optional[List[torch.Tensor]] = None
        if lens is not None:
            for x, n in zip(self.pool, lens):
                pad_past(x, n)
            self.out_lens = [torch.tensor(
                [fam.output_frames(int(v)) for v in n.tolist()],
                dtype=torch.int32, device=device) for n in lens]
        self.frames = [float(n.sum()) if lens is not None
                       else float(self.B * self.T)
                       for n in (lens or [None] * len(self.pool))]
        self.to_lists = decode_to_lists
        self._search = lambda lp, p: ctc_beam_search(
            lp, beam_width=cfg.beam_width, blank_id=cfg.blank_id,
            max_len=cfg.decode_max_len, algorithm="prefix",
            input_lengths=None if self.out_lens is None
            else self.out_lens[p])
        pick = random.Random(sub_seed(seed, 3))
        self.keep_at = {pick.randrange(2)}
        self.min_calls = max(self.keep_at) + 1
        self.kept: Dict[int, tuple] = {}
        self.last = None
        self.calls_by_batch = [0] * len(self.pool)

    def forward(self, x):
        raise NotImplementedError

    def decode(self, lp, p: int):
        return self._search(lp, p)

    def warm(self) -> None:
        for i in range(2):
            self.call(i)

    def call(self, i: int):
        p = i % len(self.pool)
        with self.spans.device("forward"):
            lp = self.forward(self.pool[p])
        with self.spans.host("decode"):
            res = self.decode(lp, p)
            with self.spans.range("lists"):
                lists = self.to_lists(res)
        return p, lp, lists

    def capture(self, i: int, out) -> None:
        if i in self.keep_at:
            self.kept[i] = out
        self.last = out
        self.calls_by_batch[out[0]] += 1

    def end_to_end(self, calls: int, window_s: float, latencies) -> Dict:
        audio_s = sum(n * f for n, f in zip(self.calls_by_batch,
                                            self.frames)) * FRAME_S
        return {"audio_s_per_s": audio_s / window_s}

    def attempted(self, calls: int) -> int:
        return calls * self.B

    def drop_program(self) -> None:
        self.params = None

    def _samples(self) -> List[tuple]:
        out = list(self.kept.values())
        if self.last is not None and all(self.last is not k for k in out):
            out.append(self.last)
        return [(self.pool[p], lp, untracked(lists), self._lens(p))
                for p, lp, lists in out]

    def _lens(self, p: int):
        return None if self.out_lens is None else self.out_lens[p]

    def numbers(self, params):
        return judge.serving_numbers(self.cell.config, params,
                                     self._samples(), self.precision())

    def control_numbers(self, params) -> Dict:
        samples = judge.control_outputs(
            self.cell.config, params,
            [(self.pool[p], self._lens(p)) for p in range(2)],
            self.precision("control_precision"))
        vals, _ = judge.serving_numbers(self.cell.config, params, samples,
                                        self.precision())
        return vals
