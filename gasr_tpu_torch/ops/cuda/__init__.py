"""Hand-written CUDA kernels (sources in `gasr_tpu_torch/csrc`), their
Python wrappers, plain PyTorch versions and launch counters."""
