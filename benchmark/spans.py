"""Sums over the program's own spans (``maxk.*``, ``maxk_tpu_torch/obs.py``)
and set-up phases, for the per-layer metrics that read them.

The trace keeps each span as a host event ``(start, end, name)`` in
``Trace.host``, on the clock of the device operations and their launch
times. Each function returns None on a run with no device operation (a
CPU run) or where the program has no such span or phase, as a program
without them has not.
"""

from __future__ import annotations

import bisect


def intervals(trace, name: str) -> list:
    """(start, end) us of each host event named ``name``, by start."""
    return sorted((s, e) for s, e, n in trace.host if n == name)


def launched_ms(run, name: str):
    """Device ms an epoch of the operations whose launch falls inside a
    ``name`` span. A span's operations may run after it ends (the host
    queues ahead), and those launched from another host thread while the
    span's thread waits (autograd's device thread) count too."""
    spans = intervals(run.trace, name)
    if not spans or not run.trace.ops:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for o in run.trace.ops:
        i = bisect.bisect_right(starts, o.launch) - 1
        if i >= 0 and o.launch <= spans[i][1]:
            total += o.end - o.start
    return total / 1e3 / run.epochs


def after_queue_ms(run, name: str):
    """ms an epoch from each ``name`` span's start, or from the end of the
    device work launched before it if that is later, to the span's end:
    ``metrics/eval_ms.py``'s rule."""
    spans = intervals(run.trace, name)
    if not spans or not run.trace.ops:
        return None
    ops = sorted(run.trace.ops, key=lambda o: o.launch)
    launches = [o.launch for o in ops]
    done, reach = [], float("-inf")
    for o in ops:
        reach = max(reach, o.end)
        done.append(reach)
    total = 0.0
    for start, end in spans:
        i = bisect.bisect_left(launches, start)
        before = done[i - 1] if i else start
        total += end - max(start, before)
    return total / 1e3 / run.epochs


def host_ms(run, name: str):
    """Host ms an epoch inside ``name`` spans."""
    spans = intervals(run.trace, name)
    if not spans or not run.trace.ops:
        return None
    return sum(e - s for s, e in spans) / 1e3 / run.epochs


def build_s(run, name: str):
    """Host seconds of the set-up phase ``name`` of the program's last
    Trainer (``maxk_tpu_torch.obs.last_build()``)."""
    if not run.trace.ops:
        return None
    try:
        from maxk_tpu_torch.obs import last_build
    except ImportError:
        return None
    seconds = last_build().get(name)
    return None if seconds is None else float(seconds)
