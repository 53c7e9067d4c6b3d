"""Kernel timing protocol.

The reference's measurement discipline: N warm-up calls, then N timed
samples averaged (reference kernels/spmm_base.h:58-74 uses 4+4 for the
MaxK kernels; kernels/spmm_cusparse.cu:35-51 uses 10+10 for the
baseline). Callers pass those counts.

On a CUDA device a sample is ``CALLS`` (20) calls queued back to back
between two CUDA events, behind a ``torch.cuda._sleep`` that keeps the
device busy while the host queues them, so that the device's work, and
not the host's launch overhead between two events, sets the time. A
single call between two events timed the host's launches on sub-ms
kernels. The sample is the events' interval over ``CALLS``. If the host
took longer to queue the calls than the sleep lasted, the device may
have waited for the host: the sample is taken again behind a sleep twice
as long.

On the CPU a sample is one call between two ``time.perf_counter``
readings: CPU ops run synchronously, so there is no queue to cover.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

CALLS = 20
# The first sleep, in device clock cycles (about 30 ms on an H100).
SLEEP_CYCLES = 50_000_000
_MAX_SLEEP_CYCLES = 64 * SLEEP_CYCLES


@dataclasses.dataclass
class TimingResult:
    mean_ms: float
    min_ms: float
    max_ms: float
    runs: int

    def nnz_per_s(self, nnz: int) -> float:
        return nnz / (self.mean_ms * 1e-3)


def _device_of(out) -> torch.device:
    """The device of the first tensor in fn's output (a tensor or a tuple
    of them)."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)):
        for o in out:
            if isinstance(o, torch.Tensor):
                return o.device
    raise TypeError(f"time_fn: fn returned no tensor ({type(out)})")


def _cuda_sample(fn: Callable, calls: int) -> float:
    """ms per call of `calls` calls queued behind a sleeping device."""
    cycles = SLEEP_CYCLES
    while True:
        torch.cuda.synchronize()
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < slept.elapsed_time(start) or cycles >= _MAX_SLEEP_CYCLES:
            return start.elapsed_time(end) / calls
        cycles *= 2


def _cpu_sample(fn: Callable) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def time_fn(fn: Callable, warmup: int = 4, runs: int = 4,
            calls: int = CALLS) -> TimingResult:
    """Time fn(): `warmup` calls, then `runs` samples (see the module
    docstring; `calls` calls a sample on CUDA). The device is the one
    that fn's output lies on."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn()
    if _device_of(out).type == "cuda":
        times = [_cuda_sample(fn, calls) for _ in range(runs)]
    else:
        times = [_cpu_sample(fn) for _ in range(runs)]
    return TimingResult(mean_ms=sum(times) / len(times), min_ms=min(times),
                        max_ms=max(times), runs=runs)
