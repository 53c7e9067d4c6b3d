"""k2_ms: device ms an epoch of K2, the CSR SpMM (``spmm_segment_kernel``
and ``spmm_finish_kernel``), from the trace."""


def read(run):
    t = run.trace.group_us().get("K2") if run.trace.ops else None
    return None if t is None else t / 1e3 / run.epochs
