"""eval_fwd_ms: device ms an epoch of the evaluation forward: the
operations launched inside the program's ``maxk.eval.forward`` spans
(``FitLoop.evaluate_masks``). None without device operations or such
spans."""

from benchmark import spans


def read(run):
    return spans.launched_ms(run, "maxk.eval.forward")
