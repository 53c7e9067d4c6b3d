"""gemm_ms: device ms an epoch of the Dense layers' GEMMs (the GEMM group
of ``trace.OP_GROUPS``), from the trace."""


def read(run):
    t = run.trace.group_us().get("GEMM") if run.trace.ops else None
    return None if t is None else t / 1e3 / run.epochs
