"""eval_copy_ms: ms an epoch of the logits' copy to the host: from each
``maxk.eval.to_host`` span's start, or from the end of the device work
launched before it if that is later, to its end (``eval_ms``'s rule on
the copy alone: the device copy and the host's staging). None without
device operations or such spans."""

from benchmark import spans


def read(run):
    return spans.after_queue_ms(run, "maxk.eval.to_host")
