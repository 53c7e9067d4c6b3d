"""step_fwd_ms: device ms an epoch of the train step's forward: the
operations launched inside ``maxk.step.forward`` spans (the model and
the loss). None without device operations or such spans."""

from benchmark import spans


def read(run):
    return spans.launched_ms(run, "maxk.step.forward")
