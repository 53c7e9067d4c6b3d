"""The golden accuracy of the port on one CUDA card: every row of
BASELINE.md's golden table (``maxk_tpu_torch/tools/golden_accuracy.py``),
each its own test case, so that a row that fails leaves the others to
run and report.

Marked ``cuda``: the cases skip without a CUDA device. On a machine with
an H100, from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \\
      -p no:randomly -rA tests/test_torch_card_golden.py

(``-rA`` prints each row's runs and means.) One module-scoped pool runs
every row's seeds, ``GOLDEN_PROCS`` runs at a time in spawned processes
(``golden_runs``; each run is deterministic, so the pool changes the
wall time and not the result). The rows and what each is held to:

- SAGE, GCN and GIN at MaxK k = 32: the mean best_test over
  ``GOLDEN_SEEDS`` (16) within ``GOLDEN_TOL`` of the row;
- GNN_res at MaxK k = 32: over the reference's seeds 97-128, the mean
  within ``GOLDEN_TOL`` of the JAX reference's over the same seeds, and
  the count below ``GOLDEN_TAIL`` against the reference's by a
  one-sided Fisher exact test (``GOLDEN_REF``);
- the other rows (SAGE at k = 8, 16, 64, the four relu rows, the four
  multilabel rows; ``GOLDEN_FLOOR_ROWS``): the mean over
  ``GOLDEN_FLOOR_SEEDS`` (8) at or above the row less ``GOLDEN_TOL``.

Each run launches K2, K1 in the maxk rows and not in the relu rows,
BatchNorm's kernels in the GNN_res rows alone, and nothing else. The
tool's ``--only-multilabel`` CLI runs once on the card; its closing line
holds the four multilabel rows with the tool's keys.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from card_inputs import card  # noqa: F401
from maxk_tpu_torch.tools.golden_accuracy import (GOLDEN_CASES,
                                                  GOLDEN_FLOOR_ROWS,
                                                  GOLDEN_FLOOR_SEEDS,
                                                  GOLDEN_REF, GOLDEN_SEEDS,
                                                  case_row, check_golden,
                                                  golden_runs)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
SEEDS = {**{name: GOLDEN_REF[name]["seeds"] if name in GOLDEN_REF
            else GOLDEN_SEEDS for name in ("sage", "gcn", "gin", "gnn_res")},
         **{name: GOLDEN_FLOOR_SEEDS for name in GOLDEN_FLOOR_ROWS}}
NORM_KERNELS = ("bn_sums", "bn_affine", "bn_dx")


@pytest.fixture(scope="module")
def golden(card):
    return golden_runs(SEEDS)


@pytest.mark.parametrize("name", list(SEEDS))
def test_golden_row(golden, name):
    row = golden[name]
    print(json.dumps({k: v for k, v in row.items() if k != "runs"}))
    print(json.dumps({r["seed"]: r["best_test"] for r in row["runs"]}))
    model, nonlinear = GOLDEN_CASES[name][:2]
    for run in row["runs"]:
        lc = run["launches"]
        assert lc["k2"] > 0, (run["seed"], lc)
        assert (lc["k1"] == 0) == (nonlinear == "relu"), (run["seed"], lc)
        assert all((lc[n] > 0) == (model == "gnn_res")
                   for n in NORM_KERNELS), (run["seed"], lc)
        assert all(lc[n] == 0 for n in lc
                   if n not in ("k1", "k2", *NORM_KERNELS)), (run["seed"],
                                                             lc)
    check_golden(row)


def test_golden_cli_only_multilabel(card):
    proc = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.tools.golden_accuracy",
         "--only-multilabel"], capture_output=True, text=True, timeout=900,
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    closing = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(closing) == ["golden_multilabel"]
    assert len(closing["golden_multilabel"]) == 4
    keys = list(case_row("sage", "maxk", 32, types.SimpleNamespace(
        best_val=0.0, best_test=0.0, best_epoch=0, epochs_run=0,
        early_stopped=False), "micro_f1"))
    assert all(list(r) == keys for r in closing["golden_multilabel"])
