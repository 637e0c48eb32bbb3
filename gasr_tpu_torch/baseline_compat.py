"""Reference benchmark-harness compatibility shim.

Drop-in for `python baseline/main.py config.json` (baseline/main.py:
59-65): reads the same JSON config list (keys batch_size, input_size,
n_context, linear_size, rnn_hidden_size, vocab_size, seg_len, epoch,
device, num_threads, beam_width) and prints the same three lines a config
("Forward: %f s" / "CTC Decode %f s" / "Overall %f s", baseline/main.py:
54-56), so tooling that parses the reference's output works against the
port.

device: "cpu" runs the port on the CPU (the kernels' plain versions);
any other value ("cuda", "gpu") runs it on the card.

Usage: python -m gasr_tpu_torch.baseline_compat <config.json>
"""

from __future__ import annotations

import json
import sys
import time


def run(config: dict) -> None:
    import torch
    from gasr_tpu_torch.config import Config, resolve_device
    from gasr_tpu_torch.decoder import ctc_beam_search
    from gasr_tpu_torch.models import model_apply, model_init
    from gasr_tpu_torch.runtime.timer import Timer

    config = dict(config, device="cpu" if config.get("device") == "cpu"
                  else "cuda")
    cfg = Config.from_dict(config)
    n_iter = cfg.epoch
    dev = resolve_device(cfg.device)
    params = model_init(cfg, torch.Generator().manual_seed(cfg.seed))
    gen = torch.Generator().manual_seed(1)

    def fwd(x):
        with torch.no_grad():
            return model_apply(cfg, params, x)

    def dec(lp):
        return ctc_beam_search(lp, beam_width=cfg.beam_width,
                               blank_id=cfg.blank_id,
                               max_len=cfg.decode_max_len)

    forward_time = decode_time = overall_time = 0.0
    for i in range(n_iter + 1):                  # +1 warm-up iteration
        inp = torch.rand((cfg.batch_size, cfg.seg_len, cfg.feat_size),
                         generator=gen).to(dev)
        Timer.sync(inp)
        t0 = time.perf_counter()
        out = fwd(inp)
        Timer.sync(out)
        t1 = time.perf_counter()
        res = dec(out)
        Timer.sync(res)
        t2 = time.perf_counter()
        if i == 0:
            continue                             # the kernels' first use
        forward_time += t1 - t0
        decode_time += t2 - t1
        overall_time += t2 - t0

    # exact output format of baseline/main.py:54-56
    print("Forward: %f s" % (forward_time / n_iter))
    print("CTC Decode %f s" % (decode_time / n_iter))
    print("Overall %f s" % (overall_time / n_iter))


def main(argv):
    with open(argv[1]) as f:
        configs = json.load(f)
    if isinstance(configs, dict):
        configs = [configs]
    for config in configs:
        print("====== config ======")
        print(config)
        print("====================")
        run(config)


if __name__ == "__main__":
    main(sys.argv)
