"""The benchmark of `gasr_tpu_torch`, the PyTorch and CUDA port: cells
named in `BENCHMARK.json`, run one at a time by `python3 -m
asrbench.run` (see `harness.py`), held to the plain reference in
`reference/`."""
