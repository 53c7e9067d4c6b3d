"""The port's train-step benchmark (maxk_tpu_torch/bench/train_bench.py)
against the JAX script (train_bench.py): the same dataset array for array,
the same training config, the JAX script's output keys, and a CPU run of
the CLI. The JAX script's main() runs with its Trainer replaced by a stub
that records what it was given, so no JAX step is traced."""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
import maxk_tpu.train.loop as jax_loop
from maxk_tpu_torch.bench import train_bench

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--n-nodes", "300", "--avg-degree", "4"]
# The suite runs several workers on the cores: one torch thread each here,
# and in the CLI's process.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def _jax_script(monkeypatch, argv):
    """(dataset, config) that train_bench.py hands its Trainer."""
    seen = {}

    class Recorder:
        def __init__(self, cfg, ds):
            seen.update(cfg=cfg, ds=ds)
            raise _Stop

    monkeypatch.setattr(jax_loop, "Trainer", Recorder)
    monkeypatch.setattr(sys, "argv", ["train_bench.py", *argv])
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("train_bench", None)
    import train_bench as jax_script
    with pytest.raises(_Stop):
        jax_script.main()
    return seen["ds"], seen["cfg"]


def test_dataset_equals_the_jax_scripts(monkeypatch):
    jds, _ = _jax_script(monkeypatch, SMALL)
    ds = train_bench.reddit_dataset(300, 4.0)
    assert (ds.name, ds.num_classes, ds.multilabel, ds.metric,
            ds.symmetric) == (jds.name, jds.num_classes, jds.multilabel,
                              jds.metric, jds.symmetric)
    np.testing.assert_array_equal(ds.csr.indptr, jds.csr.indptr)
    np.testing.assert_array_equal(ds.csr.indices, jds.csr.indices)
    np.testing.assert_array_equal(ds.csr.values, jds.csr.values)
    for field in ("features", "labels", "train_mask", "val_mask",
                  "test_mask"):
        a, b = getattr(ds, field), getattr(jds, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert ds.csr.n_edges == 2 * 300 * 4


def test_config_equals_the_jax_scripts(monkeypatch):
    argv = SMALL + ["--model", "gcn", "--maxk", "16", "--nonlinear", "relu",
                    "--hidden_dim", "64", "--hidden_layers", "2",
                    "--compute_dtype", "float32"]
    _, jcfg = _jax_script(monkeypatch, argv)
    cfg = train_bench.bench_config(train_bench.parse_args(argv))
    assert cfg.device == "cuda"
    assert {k: v for k, v in vars(cfg).items() if k != "device"} \
        == vars(jcfg)


def test_keys_are_the_jax_scripts():
    """JAX_KEYS are the keywords of the dict the JAX script prints."""
    tree = ast.parse((ROOT / "train_bench.py").read_text())
    out = next(n.value for n in ast.walk(tree)
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    assert tuple(kw.arg for kw in out.keywords) == train_bench.JAX_KEYS


def test_flag_defaults_are_the_jax_scripts():
    tree = ast.parse((ROOT / "train_bench.py").read_text())
    jax_flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            name = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            jax_flags[name] = (ast.literal_eval(kw["default"])
                               if "default" in kw else None)
    ours = vars(train_bench.parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == jax_flags


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bench.main(SMALL)


def test_cli_runs_on_cpu():
    """python -m maxk_tpu_torch.bench.train_bench at a few hundred nodes:
    one JSON line with every key of the JAX script's, a finite loss."""
    proc = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.bench.train_bench",
         "--device", "cpu", *SMALL, "--epochs", "2", "--compute_dtype",
         "float32"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, **ONE_THREAD})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(train_bench.JAX_KEYS) <= set(out)
    assert (out["metric"], out["graph"], out["n_nodes"], out["n_edges"],
            out["model"], out["nonlinear"], out["k"], out["hidden"],
            out["layers"]) == ("train_step_ms", "synthetic-reddit", 300,
                               2400, "sage", "maxk", 32, 256, 4)
    assert math.isfinite(out["loss"]) and out["loss"] > 0
    assert len(out["train_steps_ms"]) == 2
    assert out["train_step_ms"] == pytest.approx(
        sum(out["train_steps_ms"]) / 2)
    assert len(out["eval_forward_runs_ms"]) == train_bench.EVAL_RUNS
    assert out["peak_mem_gib"] is None
    assert out["device"] == {"platform": "cpu"}
    # On the CPU every op runs its kernel's plain version: no launches.
    assert set(out["launches_per_step"].values()) == {0.0}
    assert "# graph build + device put" in proc.stderr


def test_first_loss_is_the_first_steps(capsys):
    """`loss` is the loss of the first step a fresh trainer takes."""
    from maxk_tpu_torch.train.loop import Trainer
    argv = SMALL + ["--device", "cpu", "--epochs", "2", "--compute_dtype",
                    "float32", "--hidden_dim", "32", "--hidden_layers", "2",
                    "--maxk", "8", "--in-size", "16"]
    args = train_bench.parse_args(argv)
    tr = Trainer(train_bench.bench_config(args),
                 train_bench.reddit_dataset(300, 4.0, in_size=16),
                 device="cpu")
    first = float(tr.train_step())
    train_bench.main(argv)
    out = json.loads(capsys.readouterr().out)
    assert out["loss"] == first


def test_int8_compute_runs_on_the_quantized_gather(capsys):
    """--compute_dtype int8 (the JAX script's flag has no choices) trains
    on the per-column int8 table: its first loss is a Trainer's under
    "int8", and it differs from the float32 run's only by quantization."""
    argv = SMALL + ["--device", "cpu", "--epochs", "2", "--hidden_dim",
                    "32", "--hidden_layers", "2", "--maxk", "8",
                    "--in-size", "16"]
    losses = {}
    for cd in ("int8", "float32"):
        train_bench.main(argv + ["--compute_dtype", cd])
        out = json.loads(capsys.readouterr().out)
        assert out["compute_dtype"] == cd
        assert math.isfinite(out["loss"])
        losses[cd] = out["loss"]
    assert losses["int8"] != losses["float32"]
    assert losses["int8"] == pytest.approx(losses["float32"], rel=1e-2)
