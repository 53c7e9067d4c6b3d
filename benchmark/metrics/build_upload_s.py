"""build_upload_s: host seconds of the Trainer's ``build.upload`` phase
(the graph's, features', labels' and mask's copies to the device),
from ``maxk_tpu_torch.obs.last_build()``. None on a run with no device
operation (a CPU run), or where the program has no such phase."""

from benchmark import spans


def read(run):
    return spans.build_s(run, "build.upload")
