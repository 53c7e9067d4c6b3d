"""Cells, configurations, traffic, limits and metric readers are found by
the names in BENCHMARK.json; a new one is files and entries, no code."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.spec import ROOT, load_cell


def test_committed_cells_load():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.reference().NORM in ("mean", "sym")
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_a_new_cell_is_found_by_name(small):
    root = small.parent / "with_new_cell"
    shutil.copytree(small, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "gcn-products.fit", "config": "gcn-maxk-products",
        "traffic": "every2", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "launch.share", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "epoch_ms",
        "workloads": ["gcn-products.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "every2.json").write_text(
        json.dumps({"why": "evaluate every other epoch", "eval_every": 2}))
    (root / "benchmark" / "limits" / "gcn-products.fit.json").write_text(
        json.dumps({"loss1_gap": 1e-5}))
    (root / "benchmark" / "metrics" / "launch.py").write_text(
        "def read(run):\n    return 42.0\n")

    cell = load_cell("gcn-products.fit", root)
    assert cell.traffic["eval_every"] == 2
    assert cell.limits == {"loss1_gap": 1e-5}
    names = [m["name"] for m in cell.per_layer]
    assert "launch.share" in names and "eval_ms" not in names
    assert cell.reader("launch.share")(None) == 42.0
    # The committed cells do not report the new metric.
    assert "launch.share" not in [
        m["name"] for m in load_cell("gcn-products.train", root).per_layer]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        load_cell("no-such-cell")
