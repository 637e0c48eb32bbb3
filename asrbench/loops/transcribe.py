"""Batch transcription through `infer.Pipeline.transcribe` (see
`_batch.py`): the forward at the configuration's precision, the decode
and the lists in one call. A traced run calls its three stages itself
(`Pipeline.log_probs`, `ctc_beam_search`, `decode_to_lists`) so that
spans sit between them. Every utterance is "frames" long: the entry
takes no lengths."""

from __future__ import annotations

from asrbench.loops._batch import BatchLoad


class Load(BatchLoad):

    def __init__(self, cell, params, seed: int, device: str, spans):
        super().__init__(cell, params, seed, device, spans)
        if self.out_lens is not None:
            raise ValueError("Pipeline.transcribe takes no lengths: a "
                             "'transcribe' mix has no 'min_frames'")
        from gasr_tpu_torch.infer import Pipeline
        self.pipe = Pipeline(self.cfg, params=params)
        self._lp = None
        real = self.pipe.log_probs

        def keep(x):
            self._lp = real(x)
            return self._lp
        self.pipe.log_probs = keep          # transcribe calls this one

    def forward(self, x):
        return self.pipe.log_probs(x)

    def call(self, i: int):
        if self.spans.on:
            return super().call(i)
        p = i % len(self.pool)
        lists = self.pipe.transcribe(self.pool[p])
        return p, self._lp, lists

    def drop_program(self) -> None:
        super().drop_program()
        self.pipe = None
