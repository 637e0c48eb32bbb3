"""Hand-written CUDA kernels (sources in `gasr_tpu_torch/csrc`), their
Python wrappers, plain PyTorch versions and launch counters."""

import importlib
from typing import Dict

# every kernel's launch counter: name -> (module, attribute); each wrapper
# adds one where it launches its kernel
COUNTERS = {"topk": ("topk", "launches"),
            "fused_prefix_decode": ("fused_decode", "decode_launches"),
            # the decode launches of its shallow-fusion instantiation
            "fused_prefix_decode_lm": ("fused_decode", "decode_lm_launches"),
            "traceback": ("fused_decode", "traceback_launches"),
            "traceback_overlay": ("fused_decode", "overlay_launches"),
            "rnn_scan": ("rnn_scan", "launches"),
            "flash_mhsa_rel": ("flash_mhsa", "launches"),
            "fused_stem": ("stem", "launches"),
            "lstm_scan": ("lstm_scan", "launches"),
            "tp_frame": ("fused_decode", "tp_frame_launches"),
            "tp_scan": ("fused_decode", "tp_scan_launches"),
            "toy_exchange": ("exchange_probe", "toy_exchange_launches")}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches so far in this process."""
    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
            for name, (mod, attr) in COUNTERS.items()}
