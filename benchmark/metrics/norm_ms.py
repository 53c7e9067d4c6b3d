"""norm_ms: device ms an epoch of BatchNorm: the operations launched
inside the program's ``maxk.norm.forward`` spans (``BatchNorm.forward``,
training and evaluation) and ``maxk.norm.backward`` spans (the training
pass's backward, on autograd's thread). None without device operations
or without either span, as a program without them has not."""

from benchmark import spans


def read(run):
    forward = spans.launched_ms(run, "maxk.norm.forward")
    backward = spans.launched_ms(run, "maxk.norm.backward")
    if forward is None or backward is None:
        return None
    return forward + backward
