"""step_opt_ms: device ms an epoch of the optimizer: the operations
launched inside ``maxk.step.optimizer`` spans (``optimizer.step()``). None
without device operations or such spans."""

from benchmark import spans


def read(run):
    return spans.launched_ms(run, "maxk.step.optimizer")
