"""k2_roofline: % of K2's roofline: its least time over its measured time
in the window. A launch's least time is the larger of its bytes at the
published HBM rate and its operations at the float32 peak
(``counts/k2.py``); the launches are those the model makes a train step
and an evaluation (``reference/<model>.py::k2_launches``), times the
steps and the ``bench.eval`` spans of the window. None where the trace's
count of ``spmm_segment_kernel`` launches differs from that."""

import sys

from benchmark.counts import k2


def read(run):
    ops = [o for o in run.trace.in_window() if o.group == "K2"]
    if not ops:
        return None
    peaks = run.cell.peaks()
    cfg = run.cell.config
    plan = k2.plan_sizes(run.degrees)
    evals = len(run.trace.spans.get("bench.eval", []))
    launches = run.cell.reference().k2_launches(cfg)
    table = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    least, expected = 0.0, 0
    for part, times in (("train", run.epochs), ("eval", evals)):
        for n, d in launches[part]:
            flops, nbytes = k2.launch_cost(run.n_nodes, run.n_edges, *plan,
                                           d, table)
            least += times * n * max(flops / peaks["flops"]["float32"],
                                     nbytes / peaks["hbm_bytes"])
            expected += times * n
    counted = sum(k2.OP_FRAGMENTS[0] in o.name for o in ops)
    if counted != expected:
        print(f"# k2_roofline: {counted} K2 launches traced, {expected} "
              f"expected", file=sys.stderr)
        return None
    return 100.0 * least * 1e6 / sum(o.end - o.start for o in ops)
