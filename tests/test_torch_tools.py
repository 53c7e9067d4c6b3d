"""The port's tools (maxk_tpu_torch/tools/) and training recipes
(maxk_tpu_torch/scripts_train/) against the JAX package's (tools/,
scripts_train/).

- golden_accuracy: the same Cfg, cases, datasets and printed rows as the
  JAX tool (both mains run with the trainers replaced by a recorder that
  returns fixed results), and one tiny real case of each kind on the CPU;
- generate_meta: .warp4 files byte-equal to maxk_tpu.data.warp4's;
- suite_report: output byte-identical to the JAX tool's, each run as a
  subprocess, on the committed records and on a port record;
- reaudit_suite: only the port's results' rooflines are rewritten, with
  the H100 model on each graph's segment plan;
- recipes: each passes its JAX recipe's flags (both run with a stub
  `python` that records its arguments), and synthetic_smoke.sh trains on
  the CPU.
"""

import dataclasses
import importlib.util
import json
import math
import os
import stat
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
import maxk_tpu.data.datasets as jax_datasets
import maxk_tpu.train.loop as jax_loop
from maxk_tpu.data import warp4 as jax_warp4
from maxk_tpu.data.loaders import load_csr_binary as jax_load_csr_binary

import chip_smoke as cs
import maxk_tpu_torch.data.datasets as port_datasets
import maxk_tpu_torch.train.loop as port_loop
from maxk_tpu_torch.bench.harness import PROTOCOL
from maxk_tpu_torch.bench.roofline import audit_spmm
from maxk_tpu_torch.data.loaders import save_csr_binary, synthetic_graph
from maxk_tpu_torch.ops.graph import SegmentPlan
from maxk_tpu_torch.tools import (generate_meta, golden_accuracy,
                                  reaudit_suite)

ROOT = Path(__file__).resolve().parent.parent
# The suite runs several workers on the cores: one torch thread each here,
# and in every process a test starts.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
FAKE = dict(best_val=0.912345, best_test=0.987654, best_epoch=35,
            epochs_run=50, early_stopped=True)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


# -- golden_accuracy ----------------------------------------------------------

def _recorder(calls):
    class Recorder:
        def __init__(self, cfg, ds):
            cfg = dataclasses.asdict(cfg)
            cfg.pop("path")
            cfg.pop("device", None)
            calls.append((cfg, ds))

        def fit(self):
            return types.SimpleNamespace(**FAKE)
    return Recorder


def _jax_golden(monkeypatch, capsys, argv):
    """The JAX tool's printed lines and (config, dataset) of each case."""
    tool = _load_tool("golden_accuracy")
    calls, made = [], []
    monkeypatch.setattr(jax_loop, "Trainer", _recorder(calls))
    monkeypatch.setattr(jax_datasets, "make_synthetic_dataset",
                        lambda **kw: made.append(kw) or ("single", None))
    monkeypatch.setattr(
        jax_datasets, "make_synthetic_multilabel_dataset",
        lambda **kw: made.append(kw) or ("multi", kw["metric"]))
    # The JAX tool makes a directory under /tmp for each case.
    monkeypatch.setattr(tool, "Path", lambda p: types.SimpleNamespace(
        mkdir=lambda **kw: None))
    monkeypatch.setattr(sys, "argv", ["golden_accuracy.py", *argv])
    tool.main()
    return capsys.readouterr().out.splitlines(), calls, made


def _port_golden(monkeypatch, capsys, argv):
    calls = []
    monkeypatch.setattr(port_loop, "Trainer", _recorder(calls))
    monkeypatch.setattr(golden_accuracy, "_recipe_dataset", lambda metric: (
        ("single", None) if metric is None else ("multi", metric)))
    assert golden_accuracy.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out.splitlines(), calls


@pytest.mark.parametrize("argv", [[], ["--only-multilabel"]])
def test_golden_rows_equal_the_jax_tools(monkeypatch, capsys, argv):
    """Case for case: the same config and dataset, and the same printed
    rows and closing line (byte for byte), under fixed results."""
    jax_lines, jax_calls, _ = _jax_golden(monkeypatch, capsys, argv)
    port_lines, port_calls = _port_golden(monkeypatch, capsys, argv)
    assert port_lines == jax_lines
    assert port_calls == jax_calls
    assert len(port_calls) == (4 if argv else 15)
    closing = json.loads(port_lines[-1])
    assert list(closing) == ["golden_multilabel" if argv else "golden"]


def test_golden_datasets_equal_the_jax_tools(monkeypatch, capsys):
    _, _, made = _jax_golden(monkeypatch, capsys, [])
    seen = []
    monkeypatch.setattr(port_datasets, "make_synthetic_dataset",
                        lambda **kw: seen.append(kw))
    monkeypatch.setattr(port_datasets, "make_synthetic_multilabel_dataset",
                        lambda **kw: seen.append(kw))
    for metric in (None, *golden_accuracy.MULTILABEL_METRICS):
        golden_accuracy.golden_dataset(metric)
    assert seen == made
    assert golden_accuracy.GOLDEN_DATASET == cs.GOLDEN_DATASET


def test_cfg_equals_the_jax_tools():
    jax_cfg = dataclasses.asdict(_load_tool("golden_accuracy").Cfg())
    cfg = dataclasses.asdict(golden_accuracy.Cfg())
    assert cfg.pop("device") == "cuda"
    assert cfg.pop("path") == "" and jax_cfg.pop("path")
    assert cfg == jax_cfg


def test_golden_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        golden_accuracy.main(["--only-multilabel"])


TINY = dict(hidden_dim=16, hidden_layers=2, epochs=5)


@pytest.mark.parametrize("model,nonlinear,k,metric", [
    ("sage", "maxk", 8, None), ("gcn", "relu", 0, None),
    ("sage", "maxk", 8, "micro_f1"), ("sage", "relu", 0, "rocauc")])
def test_golden_tiny_case_runs(model, nonlinear, k, metric):
    """One tiny real case of each kind (V = 256, 2x16, 5 epochs) on the
    CPU: its row has the JAX tool's keys, and sane values."""
    ds = golden_accuracy.golden_dataset(metric, n_nodes=256)
    assert ds.csr.n_nodes == 256
    assert ds.multilabel == (metric is not None)
    res = golden_accuracy.fit_case(ds, model, nonlinear, k, "cpu", **TINY)
    row = golden_accuracy.case_row(model, nonlinear, k, res, metric)
    keys = ["model", "nonlinear", "k"] + (["dataset"] if metric else []) \
        + ["best_val", "best_test", "best_epoch", "epochs_run",
           "early_stopped"]
    assert list(row) == keys
    assert row["k"] == (k or None) and row["epochs_run"] == 5
    assert 0.0 <= row["best_val"] <= 1.0 and 0.0 <= row["best_test"] <= 1.0


def test_golden_run_counts_and_reports(monkeypatch):
    """golden_run: its fields, the case's dataset, and no launch on the
    CPU (every op there runs its kernel's plain version)."""
    ds = golden_accuracy.golden_dataset("rocauc", n_nodes=256)
    monkeypatch.setattr(golden_accuracy, "_recipe_dataset",
                        lambda metric: ds if metric == "rocauc" else None)

    def prepare(trainer):
        trainer.config.epochs = 5

    run = golden_accuracy.golden_run("sage", 101, "cpu", prepare,
                                     nonlinear="relu", k=0, metric="rocauc")
    assert run["model"] == "sage" and run["seed"] == 101
    assert (run["nonlinear"], run["k"], run["dataset"]) == (
        "relu", None, "synthetic_multilabel/rocauc")
    assert run["epochs_run"] == 5 and math.isfinite(run["best_test"])
    assert set(run["launches"].values()) == {0}
    again = golden_accuracy.fit_case(ds, "sage", "relu", 0, "cpu",
                                     seed=101, epochs=5)
    assert again.best_test == run["best_test"]


def test_chip_smoke_golden_rows_are_baseline_md():
    """Every case of the tool has a chip_smoke golden row, named for it,
    whose value is its BASELINE.md row."""
    text = (ROOT / "BASELINE.md").read_text()
    for model, nonlinear, k, metric in golden_accuracy.golden_cases():
        name = cs.golden_name(model, nonlinear, k, metric)
        assert cs.GOLDEN_CASES[name] == (model, nonlinear, k, metric)
        first = metric or model
        cells = f"| {first} | {nonlinear} | {k or '—'} |"
        line = next(ln for ln in text.splitlines() if ln.startswith(cells))
        assert float(line.split("|")[5]) == cs.GOLDEN_BEST_TEST[name], line


def test_chip_smoke_floor_is_one_sided():
    """Phase 21's rows are held to BASELINE.md - GOLDEN_TOL from below
    only."""
    name = cs.golden_name("sage", "maxk", 16, None)
    assert name in cs.GOLDEN_FLOOR_ROWS
    runs = [dict(model=name, seed=s, best_test=t)
            for s, t in zip(range(97, 105), [0.99] * 8)]
    high = cs.golden_row(name, runs)
    assert high["held"] == "floor" and high["gap"] > cs.GOLDEN_TOL
    cs.check_golden(high)
    low = cs.golden_row(name, [dict(r, best_test=0.92) for r in runs])
    with pytest.raises(RuntimeError, match="below"):
        cs.check_golden(low)
    # The maxk k = 32 rows stay two-sided (phases 11 and 16).
    assert cs.golden_row("sage", runs)["held"] == "row"


# -- generate_meta ------------------------------------------------------------

def test_generate_meta_files_equal_jax(tmp_path, capsys):
    gdir, out = tmp_path / "graphs", tmp_path / "out"
    graphs = {
        # A hub row of > 64 edges (split warps), symmetric.
        "hub": synthetic_graph(500, 12.0, seed=5),
        # Rows with no edges.
        "sparse": synthetic_graph(400, 0.5, seed=6, power_law=False,
                                  symmetric=False),
    }
    for name, csr in graphs.items():
        save_csr_binary(csr, gdir, name)
    assert generate_meta.main(["--graphs", str(gdir), "--out",
                               str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generating metadata")
    assert lines[1:] == ["1 hub finish", "2 sparse finish"]
    for name in graphs:
        ref = jax_warp4.generate_warp4(jax_load_csr_binary(gdir, name))
        got = (out / jax_warp4.META_DIRNAME / f"{name}.warp4").read_bytes()
        assert got == np.ascontiguousarray(ref, np.int32).tobytes()
    assert (np.diff(graphs["sparse"].indptr) == 0).any()
    assert np.diff(graphs["hub"].indptr).max() > 64


# -- suite_report -------------------------------------------------------------

def _port_record(path):
    rows = []
    for name, base in (("syn_small_d8", 0.0811), ("syn_small_d64", 0.4032)):
        rows.append(dict(
            graph=name, n_nodes=8192, n_edges=131072, avg_degree=16.0,
            dim=256, baseline_ms=base, gnna_ms=0.52,
            topk_ms={"16": 0.02, "32": 0.02},
            forward_ms={"16": 0.05, "32": 0.07},
            backward_ms={"16": 0.09, "32": 0.1},
            validation=dict(k=16, mean_err=1e-9, max_err=1e-6, n_flagged=0,
                            bwd_mean_err=1e-8, passed=True),
            roofline=dict(time_ms=base, floor_ms=0.01, serial_ms=0.03,
                          efficiency=0.5, gather_ms=0.01, stream_ms=0.01,
                          fma_ms=0.01, bound="gather", achieved_gnnz_s=1.0),
            backward_baseline_ms=0.09, coo_ms=0.3,
            fused_mask_ms={"16": 0.06, "32": 0.08}, protocol=PROTOCOL))
    path.write_text(json.dumps(dict(protocol=PROTOCOL, results=rows,
                                    device={"platform": "gpu"}), indent=2))
    return path


@pytest.mark.parametrize("argv", [
    [], ["BENCH_SUITE24.json"], ["--rmat", "BENCH_RMAT.json"],
    ["--coo", "BENCH_COO.json"], ["PORT"]], ids=[
    "default", "suite24", "rmat", "coo", "port_record"])
def test_suite_report_byte_identical(argv, tmp_path):
    if argv == ["PORT"]:
        argv = [str(_port_record(tmp_path / "port.json"))]
    env = {**os.environ, **ONE_THREAD}
    jax = subprocess.run([sys.executable, "tools/suite_report.py", *argv],
                         cwd=ROOT, capture_output=True, timeout=120, env=env)
    port = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.tools.suite_report", *argv],
        cwd=ROOT, capture_output=True, timeout=120, env=env)
    assert jax.returncode == 0 and port.returncode == 0, port.stderr
    assert jax.stdout.count(b"\n") > 4
    assert port.stdout == jax.stdout


# -- reaudit_suite ------------------------------------------------------------

def test_reaudit_rewrites_only_port_rooflines(tmp_path, capsys):
    path = _port_record(tmp_path / "rec.json")
    record = json.loads(path.read_text())
    jax_row = dict(record["results"][0], graph="syn_mid_d16", protocol=2)
    other = dict(record["results"][1], graph="reddit.dgl")
    record["results"] += [jax_row, other]
    path.write_text(json.dumps(record))
    before = json.loads(path.read_text())

    assert reaudit_suite.main([str(path)]) == 0
    out = capsys.readouterr()
    after = json.loads(path.read_text())
    assert "syn_mid_d16: protocol 2" in out.err
    assert "reddit.dgl: not a synthetic suite graph" in out.err
    assert f"# rewrote {path}" in out.out
    assert after["results"][2:] == before["results"][2:]
    for r0, r1, (v, d) in zip(before["results"][:2], after["results"][:2],
                              ((8192, 8.0), (8192, 64.0))):
        assert {k: x for k, x in r1.items() if k != "roofline"} \
            == {k: x for k, x in r0.items() if k != "roofline"}
        csr = synthetic_graph(v, d, seed=123)
        want = dataclasses.asdict(audit_spmm(
            csr.n_nodes, csr.n_edges, 256, r0["baseline_ms"],
            SegmentPlan.build(csr)))
        assert r1["roofline"] == pytest.approx(want, rel=1e-12)
        assert r1["roofline"] != r0["roofline"]


# -- recipes ------------------------------------------------------------------

RECIPES = sorted(p.name for p in (ROOT / "scripts_train").glob("*.sh")
                 if not p.name.startswith("_"))


def test_every_recipe_is_ported():
    port = sorted(p.name for p in
                  (ROOT / "maxk_tpu_torch/scripts_train").glob("*.sh"))
    assert port == sorted(RECIPES + ["_require_npz.sh"])
    assert len(RECIPES) == 11


def _run_recipe(script, args, tmp_path):
    """The argument lists of every `python` the recipe runs, through a
    stub that records them."""
    bin_dir, log = tmp_path / "bin", tmp_path / "calls.log"
    bin_dir.mkdir(exist_ok=True)
    stub = bin_dir / "python"
    stub.write_text('#!/bin/bash\nprintf "%s\\037" "$@" >> "$LOG"\n'
                    'echo >> "$LOG"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    for ds in ("reddit", "flickr", "yelp", "ogbn-products", "ogbn-proteins"):
        (data / f"{ds}.npz").touch()
    log.unlink(missing_ok=True)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               LOG=str(log), DATA_PATH=str(data))
    proc = subprocess.run(["bash", str(script), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return [line.split("\x1f")[:-1] for line in log.read_text().splitlines()]


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_flags_equal_the_jax_recipes(recipe, tmp_path):
    """Under the recipe's defaults and under other positional arguments:
    the same pre-flight calls, and the JAX recipe's train.py flags,
    given to python -m maxk_tpu_torch.train with --device cuda (or
    DEVICE)."""
    for args in ([], ["16", "3", "gcn"]):
        jax = _run_recipe(ROOT / "scripts_train" / recipe, args, tmp_path)
        port = _run_recipe(ROOT / "maxk_tpu_torch/scripts_train" / recipe,
                           args, tmp_path)
        assert port[:-1] == jax[:-1]          # tools/verify_npz.py
        assert jax[-1][0] == "train.py"
        assert port[-1][:2] == ["-m", "maxk_tpu_torch.train"]
        assert port[-1][-2:] == ["--device", "cuda"]
        assert port[-1][2:-2] == jax[-1][1:]


def test_recipe_requires_the_npz(tmp_path):
    env = dict(os.environ, DATA_PATH=str(tmp_path))
    proc = subprocess.run(
        ["bash", "maxk_tpu_torch/scripts_train/reddit_maxk.sh"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "reddit.npz not found" in proc.stderr
    assert "tools/convert_dgl_dataset.py --dataset reddit" in proc.stderr


def test_synthetic_smoke_recipe_trains_on_cpu(tmp_path):
    env = dict(os.environ, **ONE_THREAD, DEVICE="cpu", EPOCHS="3",
               PYTHONPATH=f"{ROOT}:{os.environ.get('PYTHONPATH', '')}",
               PATH=f"{Path(sys.executable).parent}:{os.environ['PATH']}")
    proc = subprocess.run(
        ["bash", str(ROOT / "maxk_tpu_torch/scripts_train"
                     / "synthetic_smoke.sh")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = list((tmp_path / "experiments").glob("synthetic_sage_maxk16_*"))
    assert len(runs) == 1
    res = json.loads((runs[0] / "final_results.json").read_text())
    assert res["results"]["epochs_run"] == 3
