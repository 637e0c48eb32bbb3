"""gasr_tpu_torch — the gasr_tpu CTC speech stack in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors `gasr_tpu`'s layout module for module, so each
counterpart is found under the same name. It imports `torch`, never
`jax`, and nothing of `gasr_tpu`: where it needs a piece of a
framework-neutral module it keeps its own copy.

What runs here (ROADMAP.md "Queue 1" lists the rest):
  - DeepSpeech-1 forward (3 x Linear+ReLU, tanh Elman RNN, Linear+ReLU,
    Linear, log_softmax), `models/deepspeech.py`;
  - greedy and log-domain prefix CTC beam-search decoding,
    `decoder/`;
  - `infer.Pipeline.transcribe`, the end-to-end entry point.

Kernels (`csrc/*.cu`, wrappers in `ops/cuda/`): the fused whole-scan
prefix decode with its stable block top-W, the backpointer traceback,
and the Elman recurrence. A wrapper given a CUDA tensor launches its
kernel or raises; given a CPU tensor it runs its plain PyTorch version.

Entry points that make tensors (`Pipeline`, `model_init`) run on the
card unless the caller asks for `device="cpu"`; with no card and no
such request they raise.
"""

__version__ = "0.1.0"

from gasr_tpu_torch.config import Config, load_configs  # noqa: F401
