"""The loops a window can drive, one file each: a traffic mix's "kind"
names the module `loops/<kind>.py`, whose class `Load` the harness
runs. A new kind of loop is a new file; no file here names another
kind.

A `Load` (see `_base.Loop` for the defaults) has:
  - `__init__(cell, params, seed, device, spans)`: the program's entry
    built on the benchmark's weights, and `pool`, the inputs drawn from
    the seed;
  - `PRECISION`: the key of the configuration's "reference_precision"
    and "control_precision" that its comparison takes;
  - `SPANS`: the host spans that label a traced window's idle gaps;
  - `min_calls`; `warm()`, set-up's calls of every shape the window
    uses; `call(i)`, the window's i-th call; `capture(i, out)`, which
    keeps what the comparison reads; `near_end(i)`, called before each
    call that may be the window's last where `NEAR_END` is true, which
    then ends only after such a call;
  - `end_to_end(calls, window_s, latencies)`: the end-to-end metrics'
    values; `attempted(calls)`; `report(latencies, log)`;
    `after_window(spans)`;
  - `leave()`, called once the window has closed: the ranks a loop of
    several processes started leave the group and end, and it returns
    each one's (card, peak memory bytes); `close()`, which stops any
    rank left, also where the run failed;
  - `drop_program()`, which frees the program's state and keeps its
    outputs; then `numbers(params)`, the comparison with the reference
    on the benchmark's weights `params` ((numbers, failed answers));
    `control_numbers(params)`, the same with the control in the
    program's place; `fault_numbers(params)`, {fault: numbers} of faults
    planted in the reference in the program's place.
"""

import importlib
import re

KIND = re.compile(r"^[A-Za-z][A-Za-z0-9_]{0,63}$")


def load_class(kind: str):
    """The `Load` class of loop `kind` (`loops/<kind>.py`)."""
    if not KIND.match(kind):
        raise KeyError(f"asrbench: {kind!r} is no loop kind")
    try:
        mod = importlib.import_module(f"asrbench.loops.{kind}")
    except ModuleNotFoundError as e:
        raise KeyError(f"asrbench: no loop kind {kind!r} "
                       f"(asrbench/loops/{kind}.py)") from e
    return mod.Load
