"""The benchmark's cells cut to a size the CPU runs in a second: the same
files, fewer rows, frames, units and blocks (never in the benchmark's
own runs)."""

import copy

from asrbench.manifest import load_cell

DS = dict(linear_size=64, rnn_hidden_size=128)
CONF = dict(d_model=64, num_blocks=2, vocab_size=16)


def tiny_cell(name: str):
    c = copy.deepcopy(load_cell(name))
    if c.config["family"] == "deepspeech":
        c.config["model"].update(DS)
        c.config["program"].update(DS, beam_width=8)
        if c.traffic["kind"] != "stream":
            c.traffic.update(batch=8, frames=30, pool=2)
        else:
            c.traffic.update(streams=8, frames=30, chunk_frames=10, pool=2)
    else:
        prog = c.config["program"]
        if prog.get("blank_id", 0) == prog["vocab_size"]:
            prog["blank_id"] = CONF["vocab_size"]    # blank last, as cut
        c.config["model"].update(CONF)
        prog.update(linear_size=64, rnn_hidden_size=64, num_blocks=2,
                    vocab_size=16, beam_width=4)
        c.config["reference_block_rows"] = 2
        c.traffic.update(batch=4, frames=48, pool=3)
        if "min_frames" in c.traffic:
            c.traffic["min_frames"] = 40
    return c
