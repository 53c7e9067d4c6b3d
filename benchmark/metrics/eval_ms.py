"""eval_ms: ms an epoch that the evaluation adds, from the trace: for each
``bench.eval`` span (the benchmark's span around ``evaluate_masks``), from
its start, or from the end of the device work launched before it if that
is later, to its end. That is the evaluation forward, the copy of the
logits and the host's metrics, and not the wait for the train step."""

import bisect


def read(run):
    spans = run.trace.spans.get("bench.eval")
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
