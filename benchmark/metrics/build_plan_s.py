"""build_plan_s: host seconds of the Trainer's ``build.segment_plan``
phase (K2's ``SegmentPlan.build`` and its copies to the device), from
``maxk_tpu_torch.obs.last_build()``. None on a run with no device
operation (a CPU run), or where the program has no such phase."""

from benchmark import spans


def read(run):
    return spans.build_s(run, "build.segment_plan")
