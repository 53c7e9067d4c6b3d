"""idle_share: % of the traced window in which no device operation ran
(the window less the union of the kernels', copies' and sets'
intervals)."""


def read(run):
    lo, hi = run.trace.window
    if not run.trace.ops or hi <= lo:
        return None
    busy, _ = run.trace.busy_and_gaps()
    return 100.0 * (hi - lo - busy) / (hi - lo)
