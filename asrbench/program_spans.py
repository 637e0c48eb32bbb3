"""The program's own spans, read after a traced window from
`gasr_tpu_torch.runtime.profiler.records()`.

The program records only while a profiler runs, and `harness.run` runs
one profiler session a process, opened just before the window's
annotation and closed after the window's fence: the session's spans are
the window's. A program without the recorder gives None, so a metric
read here is left out of its line.
"""

from __future__ import annotations

from typing import Optional


def records():
    """The program's records of the last profiler session, or None."""
    try:
        from gasr_tpu_torch.runtime.profiler import records as read
    except ImportError:
        return None
    return read()


# the lists' copies to the host (`decode_to_lists`'s `.cpu()` calls): in
# the traced cells no other copy lands in pageable memory in the window
PAGEABLE_DTOH = "DtoH (Device -> Pageable)"


def host_ms_per_call(r, name: str) -> Optional[float]:
    """Host ms in the program's spans named `name` in the traced window
    (each span's end less its start, on the host's clock) / the window's
    calls."""
    rec = records()
    if rec is None or not r.calls:
        return None
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.name == name and s.end_ns is not None)
    return ns * 1e-6 / r.calls


def lists_ms_per_call(r) -> Optional[float]:
    """The lists' own ms a call: host ms in "decode.lists.build" plus the
    device ms of the window's pageable device-to-host copies, leaving out
    the part of "decode.lists.fetch" that waits for the decode."""
    build = host_ms_per_call(r, "decode.lists.build")
    if build is None:
        return None
    copy_s = r.trace.seconds(PAGEABLE_DTOH)[0] if r.trace is not None else 0.0
    return build + copy_s * 1e3 / r.calls
