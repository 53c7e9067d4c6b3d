"""step_bwd_ms: device ms an epoch of the train step's backward: the
operations launched inside ``maxk.step.backward`` spans (``zero_grad`` and
``loss.backward()``), autograd's device thread's launches included. None
without device operations or such spans."""

from benchmark import spans


def read(run):
    return spans.launched_ms(run, "maxk.step.backward")
