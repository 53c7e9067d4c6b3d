"""The device trace of a measured window, and the sums read from it.

``traced`` runs a window under ``torch.profiler`` (CPU, and CUDA on a
card); ``Trace.load`` reads the exported Chrome trace: every device
operation (kernels, copies, sets) with the time the host launched it,
the benchmark's own spans (``record_function``) and the host's
operations. Kernels are grouped by name (``OP_GROUPS``, the groups of
``chip_smoke.py``). Busy time is the union of the device operations'
intervals inside the window; idle gaps are named by the innermost host
operation or span that was open when the gap began.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import os
import tempfile

OP_GROUPS = (
    ("K1", ("maxk_topk_kernel",)),
    ("K2", ("spmm_segment_kernel", "spmm_finish_kernel")),
    ("K3", ("cbsr_gather_kernel",)),
    ("K4", ("cbsr_topk_kernel",)),
    ("K5", ("spgemm_cbsr_kernel", "spgemm_cbsr_pack_kernel",
            "spgemm_cbsr_finish_kernel")),
    ("K6", ("cbsr_expand_kernel",)),
    ("K7", ("spmm_int8_segment_kernel", "spmm_int8_finish_kernel")),
    ("wide", ("topk_wide_kernel",)),
    ("GEMM", ("gemm", "gemv", "nvjet", "splitKreduce", "cutlass")),
    ("LayerNorm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("dropout RNG", ("distribution_", "philox")),
    ("Adam", ("multi_tensor_apply",)),
    ("casts and elementwise", ("elementwise", "copy_kernel", "fill")),
)
WINDOW = "bench.window"
DEVICE_CATS = {"kernel": None, "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def op_group(name: str) -> str:
    return next((group for group, fragments in OP_GROUPS
                 if any(f in name for f in fragments)), "other")


@dataclasses.dataclass
class DeviceOp:
    name: str
    group: str
    start: float      # us
    end: float
    launch: float     # host time of its launch (us); its start if unknown


@dataclasses.dataclass
class Trace:
    ops: list          # DeviceOp, by start
    spans: dict        # benchmark span name -> [(start, end)] (us)
    host: list         # (start, end, name) host operations, by start
    window: tuple      # (start, end) us of the measured window
    unlinked: int      # device ops whose launch was not found

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launches, spans, host, raw = {}, {}, [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), e["ts"], e.get("dur", 0.0)
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                raw.append((e["name"], cat, ts, ts + dur, corr))
                continue
            if cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
            if cat == "user_annotation" and e["name"].startswith("bench."):
                spans.setdefault(e["name"], []).append((ts, ts + dur))
            if cat in HOST_CATS:
                host.append((ts, ts + dur, e["name"]))
        ops, unlinked = [], 0
        for name, cat, start, end, corr in raw:
            group = DEVICE_CATS[cat] or op_group(name)
            launch = launches.get(corr)
            if launch is None:
                unlinked += 1
                launch = start
            ops.append(DeviceOp(name, group, start, end, launch))
        ops.sort(key=lambda o: o.start)
        host.sort()
        for v in spans.values():
            v.sort()
        window = spans.get(WINDOW, [(0.0, 0.0)])[0]
        return Trace(ops, spans, host, window, unlinked)

    def in_window(self) -> list:
        lo, hi = self.window
        return [o for o in self.ops if o.end > lo and o.start < hi]

    def busy_and_gaps(self) -> tuple[float, list]:
        """(busy us, [(gap start, gap end)]) inside the window: the union
        of the device operations' intervals, clipped to it, and the
        stretches between them."""
        lo, hi = self.window
        busy, reach, gaps = 0.0, lo, []
        for o in self.in_window():
            s, e = max(o.start, lo), min(o.end, hi)
            if s > reach:
                gaps.append((reach, s))
            if e > reach:
                busy += e - max(s, reach)
                reach = e
        if hi > reach:
            gaps.append((reach, hi))
        return busy, gaps

    def group_us(self) -> dict:
        """Device time (us) of each group inside the window."""
        out = {}
        for o in self.in_window():
            out[o.group] = out.get(o.group, 0.0) + o.end - o.start
        return out

    def name_gaps(self, gaps: list) -> dict:
        """Idle us by the innermost host operation open at each gap's
        start ("host, untraced" where none is)."""
        out, active, i = {}, [], 0
        for start, end in sorted(gaps):
            while i < len(self.host) and self.host[i][0] <= start:
                s, e, name = self.host[i]
                heapq.heappush(active, (-s, e, name))
                i += 1
            while active and active[0][1] <= start:
                heapq.heappop(active)
            name = active[0][2] if active else "host, untraced"
            out[name] = out.get(name, 0.0) + end - start
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device groups that took most time and the longest idle
        time by host activity, in seconds, at most ``top`` each."""
        _, gaps = self.busy_and_gaps()

        def largest(d: dict) -> list:
            return [[k, v / 1e6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": largest(self.group_us()),
                "idle_gaps": largest(self.name_gaps(gaps))}


@contextlib.contextmanager
def traced(on_cuda: bool):
    """Profile the body; yields a one-element list that holds the
    ``Trace`` once the body has ended. The Chrome trace is written to a
    temporary file and removed once read."""
    from torch import profiler
    activities = [profiler.ProfilerActivity.CPU]
    if on_cuda:
        activities.append(profiler.ProfilerActivity.CUDA)
    out = []
    with profiler.profile(activities=activities) as prof:
        yield out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out.append(Trace.load(path))
    finally:
        os.remove(path)
