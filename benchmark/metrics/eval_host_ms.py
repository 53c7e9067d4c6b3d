"""eval_host_ms: host ms an epoch of the evaluation's metrics, the
``maxk.eval.metrics`` spans (three accuracies in numpy); the card has
nothing queued during them. None without device operations or such
spans."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, "maxk.eval.metrics")
