"""build_normalize_s: host seconds of the Trainer's ``build.normalize``
phase (``CSRGraph.normalize`` and ``mean_transpose_values``), from
``maxk_tpu_torch.obs.last_build()``. None on a run with no device
operation (a CPU run), or where the program has no such phase."""

from benchmark import spans


def read(run):
    return spans.build_s(run, "build.normalize")
