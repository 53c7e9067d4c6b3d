"""Fixtures of the benchmark's tests: a copy of the benchmark's root at a
size the CPU runs in seconds, and the card for the tests marked cuda."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.spec import ROOT

# Every width and depth of the configurations kept; only the graph is
# small.
SMALL_GRAPH = {"n_nodes": 600, "n_edges": 12000, "max_degree": 150,
               "split": [300, 100, 200]}


def small_root(dest: Path, graph: dict = SMALL_GRAPH) -> Path:
    """A benchmark root under ``dest``: BENCHMARK.json and the benchmark's
    data files as committed, with each configuration's graph made small."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, dest / "benchmark" / sub)
    shutil.copy(ROOT / "benchmark" / "peaks.json",
                dest / "benchmark" / "peaks.json")
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["graph"].update(graph)
        path = dest / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> Path:
    return small_root(tmp_path_factory.mktemp("bench_root"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
