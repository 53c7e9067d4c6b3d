"""step_mfu: % of the card's peak in the model's FLOPs over the traced
window: every train step's and every evaluation's FLOPs
(``reference/<model>.py::flops``, counted from shapes) over the window's
length times the peak of the precision the configuration states for its
Dense layers."""


def read(run):
    lo, hi = run.trace.window
    if not run.trace.ops or hi <= lo:
        return None
    cfg, g = run.cell.config, run.cell.config["graph"]
    train, evaluation = run.cell.reference().flops(
        cfg, run.n_nodes, run.n_edges, g["n_features"], g["n_classes"])
    evals = len(run.trace.spans.get("bench.eval", []))
    total = run.epochs * train + evals * evaluation
    peak = run.cell.peaks()["flops"][cfg["dense_dtype"]]
    return 100.0 * total / ((hi - lo) / 1e6 * peak)
