"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is jax, jaxlib, flax or maxk_tpu,
in a whole run; and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.spec import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "maxk_tpu"}


def _subprocess(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    from benchmark.tests.conftest import small_root
    root = small_root(tmp_path)
    got = _subprocess(f"""
import json, sys
from pathlib import Path
from benchmark import run
from benchmark.spec import load_cell
r = run.run(load_cell("sage-reddit.fit", Path({str(root)!r})), 7, 0.1,
            True, "cpu")
print(json.dumps({{"correct": r["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "flagged": run.forbidden_modules()}}))
""")
    assert got["correct"] is True
    assert "maxk_tpu_torch" in got["top"]          # the program ran
    assert not FORBIDDEN & set(got["top"]) and got["flagged"] == []


def test_the_flag_compares_whole_names(monkeypatch):
    from benchmark import run
    before = set(run.forbidden_modules())    # a test plugin may load jax
    monkeypatch.setitem(sys.modules, "maxk_tpu_torch_extra", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "maxk_tpu.ops", sys)
    assert set(run.forbidden_modules()) == before | {"maxk_tpu"}


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    # The GNN_res cell's inputs and reference run too: a model with state.
    got = _subprocess(f"""
import json, sys
from pathlib import Path
import benchmark.reference.sage, benchmark.reference.gcn, benchmark.check
import benchmark.reference.gnn_res
import benchmark.counts.k2, benchmark.graphs.generate
from benchmark import cell
from benchmark.spec import load_cell
from benchmark.tests import conftest
root = conftest.add_gnnres_cell(conftest.small_root(Path({str(tmp_path)!r})),
                                conftest.GNNRES_LIMITS)
c = load_cell(conftest.GNNRES_CELL, root)
ref = cell.reference(c, cell.make_inputs(c, 7, "cpu"), "cpu")
assert ref.state_changes and ref.eval_logits is not None
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert not (FORBIDDEN | {"maxk_tpu_torch"}) & set(got)


def test_no_benchmark_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
            if path.parent.name == "reference":
                for name in names:
                    assert name.split(".")[0] != "maxk_tpu_torch", path
