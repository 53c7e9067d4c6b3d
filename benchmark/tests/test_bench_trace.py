"""The trace's reading on a hand-made Chrome trace: busy time, idle gaps
named by the host's open span, the launch links, and the readers of the
device metrics."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark.spec import load_cell
from benchmark.trace import Trace, op_group

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0,
     "dur": 1000},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 20, "dur": 10},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10,
     "dur": 1, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20,
     "dur": 1, "args": {"correlation": 2}},
    {"ph": "X", "cat": "user_annotation", "name": "bench.eval", "ts": 50,
     "dur": 650},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60,
     "dur": 1, "args": {"correlation": 3}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 65,
     "dur": 1, "args": {"correlation": 4}},
    {"ph": "X", "cat": "kernel", "name": "void spmm_segment_kernel<4>()",
     "ts": 100, "dur": 200, "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32", "ts": 300,
     "dur": 100, "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel",
     "ts": 450, "dur": 50, "args": {"correlation": 3}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 500,
     "dur": 50, "args": {"correlation": 4}},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return Trace.load(str(path))


def test_groups():
    assert op_group("void spmm_finish_kernel<float>()") == "K2"
    assert op_group("ampere_sgemm_128x64_nn") == "GEMM"
    assert op_group("something_else") == "other"


def test_busy_gaps_and_breakdown(trace):
    busy, gaps = trace.busy_and_gaps()
    assert busy == 400 and gaps == [(0, 100), (400, 450), (550, 1000)]
    assert trace.unlinked == 0
    assert [o.launch for o in trace.ops] == [10, 20, 60, 65]
    b = trace.breakdown()
    assert b["device_ops"][0] == ["K2", 200e-6]
    assert dict(map(tuple, b["idle_gaps"])) == {"bench.window": 100e-6,
                                                "bench.eval": 500e-6}


def test_readers(trace, small):
    cell = load_cell("sage-reddit.fit", small)
    run = SimpleNamespace(cell=cell, trace=trace, epochs=1,
                          trainer_build_s=1.5, n_nodes=600, n_edges=12600,
                          degrees=torch.full((600,), 21))
    assert cell.reader("idle_share")(run) == pytest.approx(60.0)
    assert cell.reader("eval_ms")(run) == pytest.approx(0.3)
    assert cell.reader("k2_ms")(run) == pytest.approx(0.2)
    assert cell.reader("gemm_ms")(run) == pytest.approx(0.1)
    assert cell.reader("trainer_build_s")(run) == 1.5
    # One K2 launch traced where the model makes 8 + 4 an epoch: no reading.
    assert cell.reader("k2_roofline")(run) is None
    mfu = cell.reader("step_mfu")(run)
    train, evaluation = cell.reference().flops(cell.config, 600, 12600,
                                               602, 41)
    assert mfu == pytest.approx(100 * (train + evaluation) / (1e-3 * 67e12))


def test_readers_find_nothing_without_device_ops(tmp_path, small):
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"traceEvents": EVENTS[:2]}))
    cell = load_cell("gcn-products.train", small)
    run = SimpleNamespace(cell=cell, trace=Trace.load(str(path)), epochs=3,
                          trainer_build_s=0.5, n_nodes=600, n_edges=12600,
                          degrees=torch.full((600,), 21))
    for name in ("idle_share", "eval_ms", "k2_ms", "gemm_ms", "k2_roofline",
                 "step_mfu"):
        assert cell.reader(name)(run) is None
