"""What a cell is made of, found by name under the benchmark's root.

``BENCHMARK.json`` names every configuration, cell and metric. The rest
is files, one each, found by the names in it:

- a configuration's JSON file (its ``file`` entry), whose ``"model"``
  names its plain reference, ``benchmark/reference/<model>.py``;
- a traffic mix, ``benchmark/traffic/<traffic>.json``;
- the limits of a cell's comparison, ``benchmark/limits/<cell>.json``;
- a per-layer metric's reader, ``benchmark/metrics/<quantity>.py``, whose
  ``read(run)`` returns the metric or None. A metric's name is its
  quantity, then, after a dot, the cells it is read in where one quantity
  has several metrics: ``k2_ms.fit`` moves ``epoch_ms.fit``;
- the table of published peaks, ``benchmark/peaks.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration's file, as it is run
    traffic: dict         # the traffic mix's parameters
    limits: dict          # number -> limit of the comparison
    chips: int
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path

    def reference(self) -> ModuleType:
        return importlib.import_module(
            f"benchmark.reference.{self.config['model']}")

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's file: that of its
        quantity, the name's part before the first dot."""
        quantity = metric.split(".")[0]
        path = self.root / "benchmark" / "metrics" / f"{quantity}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark.metrics.{quantity}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def peaks(self) -> dict:
        return _json(self.root / "benchmark" / "peaks.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(root / "benchmark" / "traffic"
                      / f"{w['traffic']}.json"),
        limits=_json(root / "benchmark" / "limits" / f"{name}.json"),
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)
