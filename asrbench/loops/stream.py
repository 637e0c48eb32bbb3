"""Live streams: "streams" streams at a time, each "frames" frames long
in chunks of "chunk_frames". A chunk is the forward with the
recurrence's state carried (`deepspeech_apply_streaming`), then
`streaming_step`, then `decode_to_lists` of its snapshot, so that every
stream's partial transcript is on the host. When a group of streams
ends, the next begins, from a pool of "pool" groups. The program's
streaming entry advances a batch of streams together, so a group's
streams start and end together."""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from asrbench import judge
from asrbench.common import (features, generator, percentile_ms,
                             program_config, sub_seed, untracked)
from asrbench.loops._base import Loop


class Load(Loop):
    PRECISION = "stream"
    SPANS = ("forward", "decode", "lists")

    def __init__(self, cell, params, seed: int, device: str, spans):
        from gasr_tpu_torch.decoder.beam_search import (decode_to_lists,
                                                        streaming_init,
                                                        streaming_step)
        from gasr_tpu_torch.models.deepspeech import (
            deepspeech_apply_streaming)
        t = cell.traffic
        self.cell = cell
        self.cfg = cfg = program_config(cell, device)
        self.S, self.T, self.Tc = t["streams"], t["frames"], t["chunk_frames"]
        self.n_chunks = self.T // self.Tc
        self.pool = features(generator(seed, 2, device), t["pool"], self.S,
                             self.T, cfg.feat_size, device)
        self.params, self.spans, self.device = params, spans, device
        self.apply = deepspeech_apply_streaming
        self.init, self.step, self.to_lists = (streaming_init,
                                               streaming_step,
                                               decode_to_lists)
        pick = random.Random(sub_seed(seed, 3))
        self.keep_group = pick.randrange(2)
        self.min_calls = (self.keep_group + 1) * self.n_chunks
        self.kept: List[tuple] = []
        self._cur: Optional[tuple] = None
        self._complete: Optional[tuple] = None
        self.rnn = self.state = None

    def warm(self) -> None:
        for i in range(self.n_chunks):
            self.call(i)
        self._cur = self._complete = None

    def call(self, i: int):
        g, c = divmod(i, self.n_chunks)
        x = self.pool[g % len(self.pool)][:, c * self.Tc:(c + 1) * self.Tc]
        if c == 0:
            self.rnn = self.state = None
        with self.spans.device("forward"):
            with torch.no_grad():
                lp, self.rnn = self.apply(self.params, x, self.rnn)
        with self.spans.host("decode"):
            if self.state is None:
                self.state = self.init(self.S, self.cfg.beam_width,
                                       max_len=self.cfg.decode_max_len,
                                       device=self.device)
            self.state, snap = self.step(self.state, lp,
                                         blank_id=self.cfg.blank_id,
                                         is_final=c == self.n_chunks - 1)
            with self.spans.range("lists"):
                lists = self.to_lists(snap)
        return g, c, lp, lists

    def capture(self, i: int, out) -> None:
        # the group's partial transcripts are kept untracked, out of the
        # collector's scans, which the window leaves on
        g, c, lp, lists = out
        if c == 0:
            self._cur = (g, [], [])
        self._cur[1].append(lp)
        self._cur[2].append(untracked(lists))
        if c == self.n_chunks - 1:
            if g == self.keep_group:
                self.kept.append(self._cur)
            self._complete = self._cur

    def end_to_end(self, calls: int, window_s: float, latencies) -> Dict:
        return {"chunk_ms_p95": percentile_ms(latencies, 95)}

    def attempted(self, calls: int) -> int:
        return calls * self.S

    def report(self, latencies: List[float], log) -> None:
        by = [latencies[c::self.n_chunks] for c in range(self.n_chunks)]
        log("asrbench: host ms by chunk index, p50 / p95: " + ", ".join(
            f"{c}: {percentile_ms(v, 50):.2f} / {percentile_ms(v, 95):.2f}"
            for c, v in enumerate(by) if v))

    def drop_program(self) -> None:
        self.state = self.rnn = self.params = None

    def numbers(self, params):
        out = list(self.kept)
        if self._complete is not None and all(self._complete is not k
                                              for k in out):
            out.append(self._complete)
        samples = [(self.pool[g % len(self.pool)], torch.cat(lps), lists,
                    None) for g, lps, lists in out]
        return judge.serving_numbers(self.cell.config, params, samples,
                                     self.precision(), self.Tc)

    def control_numbers(self, params) -> Dict:
        samples = judge.control_outputs(
            self.cell.config, params, [(x, None) for x in self.pool[:2]],
            self.precision("control_precision"), self.Tc)
        vals, _ = judge.serving_numbers(self.cell.config, params, samples,
                                        self.precision(), self.Tc)
        return vals
