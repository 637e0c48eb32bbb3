"""Typed run configuration — the same fields and presets as
`gasr_tpu.config`, so configs and JSON files carry across unchanged.

Differences from the JAX package:
  - `device` defaults to "cuda" (the H100); "cpu" is the only other
    value. `resolve_device` raises when "cuda" is asked for and no card
    is present: nothing falls back to the CPU quietly.
  - `rnn_impl="pallas"` keeps its name so configs carry across; here it
    selects the hand-written CUDA recurrence kernels, the Elman one
    (`ops/cuda/rnn_scan.py`) for deepspeech and the LSTM one
    (`ops/cuda/lstm_scan.py`) for bilstm and deepspeech2, on the shapes
    that JAX's rule admits (H % 128 == 0 and B % 8 == 0; the float32
    loop elsewhere, as in JAX), and the same holds for the decoder's
    `merge_impl="pallas"` (`ops/cuda/fused_decode.py`) and the
    conformer's `attn_impl` / `stem_impl="pallas"`
    (`ops/cuda/flash_mhsa.py`, `ops/cuda/stem.py`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Config:
    # ---- reference keys (baseline/config.json) ----
    batch_size: int = 256
    input_size: int = 26
    n_context: int = 1
    linear_size: int = 2048
    rnn_hidden_size: int = 2048
    vocab_size: int = 46          # WITHOUT blank; model output dim = vocab_size + 1
    seg_len: int = 200            # frames per utterance (T)
    epoch: int = 10               # bench iterations
    device: str = "cuda"          # "cuda" (default) | "cpu"
    num_threads: int = 4          # reference: ctcdecode CPU threads; kept for compat
    beam_width: int = 100

    # ---- framework extensions ----
    model: str = "deepspeech"     # deepspeech | bilstm | deepspeech2 | conformer_s | conformer_l
    rnn_num_layers: int = 1
    bidirectional: bool = False
    compute_dtype: str = "float32"   # float32 | bfloat16 (params stay f32)
    blank_id: int = 0
    decode_max_len: int = 256
    cmvn: bool = False
    decoder: str = "prefix"       # prefix | reference | greedy
    log_space: bool = True
    num_blocks: Optional[int] = None  # conformer depth override (None=preset)
    rnn_impl: str = "scan"        # scan | pallas (= the CUDA recurrence kernel)
    # mesh: axis name -> size; empty = single device
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    seed: int = 0

    @property
    def feat_size(self) -> int:
        """Model input feature width: input_size*(1+2*n_context)."""
        return self.input_size + 2 * self.input_size * self.n_context

    @property
    def output_size(self) -> int:
        """Logit width = vocab + blank."""
        return self.vocab_size + 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**known)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_configs(path: str) -> List[Config]:
    """Load a JSON list of configs (reference format)."""
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        raw = [raw]
    return [Config.from_dict(d) for d in raw]


def resolve_device(device: str):
    """Config.device -> torch.device; raises for "cuda" without a card."""
    import torch
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for (the default) but torch finds no "
            "CUDA device; pass device='cpu' to run the plain versions on "
            "the CPU")
    return torch.device("cuda")


# The same presets as gasr_tpu.config.PRESETS; only `device` differs.
PRESETS: Dict[str, Config] = {
    "reference_large_cpu": Config(device="cpu"),
    "reference_large": Config(device="cuda"),
    "reference_toy": Config(
        batch_size=3, input_size=10, n_context=0, linear_size=40,
        rnn_hidden_size=50, vocab_size=3, seg_len=9, epoch=1,
        beam_width=2, decode_max_len=32,
    ),
    "bilstm_2x256": Config(
        model="bilstm", batch_size=16, input_size=80, n_context=0,
        linear_size=256, rnn_hidden_size=256, rnn_num_layers=2,
        bidirectional=True, vocab_size=28, seg_len=400, beam_width=10,
    ),
    "deepspeech2": Config(
        model="deepspeech2", batch_size=32, input_size=160, n_context=0,
        linear_size=512, rnn_hidden_size=512, rnn_num_layers=5,
        bidirectional=True, vocab_size=28, seg_len=600, beam_width=32,
    ),
    "conformer_s": Config(
        model="conformer_s", batch_size=32, input_size=80, n_context=0,
        linear_size=144, rnn_hidden_size=144, vocab_size=128, seg_len=600,
        beam_width=64, compute_dtype="bfloat16",
    ),
    "conformer_l": Config(
        model="conformer_l", batch_size=64, input_size=80, n_context=0,
        linear_size=512, rnn_hidden_size=512, vocab_size=128, seg_len=1200,
        beam_width=16, mesh_shape={"data": 2, "model": 4},
        compute_dtype="bfloat16",
    ),
}
