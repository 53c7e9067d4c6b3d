"""norm_roofline: % of BatchNorm's roofline: its least time
(``counts/batchnorm.py``: a forward and a backward a layer a train step,
a forward a layer an evaluation) over ``norm_ms``. None where that is
None, or where the trace's count of ``maxk.norm.forward`` spans differs
from the layers times the steps and the ``bench.eval`` spans of the
window, or that of ``maxk.norm.backward`` from the layers times the
steps."""

import sys

from benchmark import spans
from benchmark.counts import batchnorm


def read(run):
    measured = run.cell.reader("norm_ms")(run)
    if not measured:
        return None
    cfg = run.cell.config
    layers, steps = cfg["hidden_layers"], run.epochs
    evals = len(run.trace.spans.get("bench.eval", []))
    counted = (len(spans.intervals(run.trace, "maxk.norm.forward")),
               len(spans.intervals(run.trace, "maxk.norm.backward")))
    expected = (layers * (steps + evals), layers * steps)
    if counted != expected:
        print(f"# norm_roofline: {counted} BatchNorm forward and backward "
              f"spans traced, {expected} expected", file=sys.stderr)
        return None
    least = batchnorm.least_s(layers, run.n_nodes, cfg["hidden_dim"], steps,
                              evals, run.cell.peaks())
    return 100.0 * least * 1e3 / (measured * run.epochs)
