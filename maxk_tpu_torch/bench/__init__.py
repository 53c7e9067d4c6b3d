"""Kernel benchmark harness: timing, the H100 roofline, the per-graph
harness, the direct kernel interface and the two entry points
(``python -m maxk_tpu_torch.bench.kernel_bench`` and ``.headline``)."""

from maxk_tpu_torch.bench.timing import TimingResult, time_fn

__all__ = ["time_fn", "TimingResult"]
