"""gasr_tpu_torch — the gasr_tpu CTC speech stack in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors `gasr_tpu`'s layout module for module, so each
counterpart is found under the same name. It imports `torch`, never
`jax`, and nothing of `gasr_tpu`: where it needs a piece of a
framework-neutral module it keeps its own copy.

The port does all that `gasr_tpu` does (tests/test_torch_parity.py holds
its public API to JAX's, module by module). Among what runs here:
  - DeepSpeech-1 forward (3 x Linear+ReLU, tanh Elman RNN, Linear+ReLU,
    Linear, log_softmax), `models/deepspeech.py`;
  - Conformer-CTC forward (conv subsampling stem, rel-pos MHSA blocks,
    bf16 mixed precision), `models/conformer.py`;
  - greedy decoding and CTC beam search, the "prefix" and "reference"
    algorithms (log or prob domain, matched or sort merge, exact or
    approx top-k), batch and streaming (`streaming_init` /
    `streaming_step`), with bigram shallow fusion (`lm_bias`, tables from
    `decoder/lm.py`), `decoder/`;
  - the audio front end: the native C++ log-mel (`native/`, built with
    g++ at first use), `logmel_torch`, `cmvn`, `add_context`
    (`data/features.py`) and the dataset helpers (`data/dataset.py`);
  - `infer.Pipeline.transcribe`, `transcribe_streaming` and
    `transcribe_audio`, the end-to-end entry points, and WER evaluation
    (`eval.py`);
  - device meshes (`parallel/mesh.py`) and the vocab-sharded
    (tensor-parallel) beam search, batch and streaming
    (`parallel/decode_tp.py`), on shards that share a card or sit on
    several cards of one host.

Kernels (`csrc/*.cu`, wrappers in `ops/cuda/`): the fused whole-scan
prefix decode with its exact threshold-filtered top-W (with and without
the bigram table), the backpointer traceback,
the streaming chunk's traceback with the base overlay, the Elman and
LSTM recurrences, the rel-pos flash attention, the fused conformer stem
(conv2 + sub_proj), the vocab-sharded local frame and whole scan with
its in-kernel winner exchange, and that exchange's toy. A wrapper given a CUDA tensor launches its
kernel or raises; given a CPU tensor it runs its plain PyTorch version.

Entry points that make tensors (`Pipeline`, `model_init`) run on the
card unless the caller asks for `device="cpu"`; with no card and no
such request they raise.
"""

__version__ = "0.1.0"

from gasr_tpu_torch.config import Config, load_configs  # noqa: F401
