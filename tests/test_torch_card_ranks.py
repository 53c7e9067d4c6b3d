"""Row-partitioned training and tensor parallelism on the card, at the
131,072-node cell of ``bench/kernel_table.py`` (SAGE 4x256, k = 32,
bf16, norm, dropout 0.5, seed 97, bench.py's dataset).

Marked ``cuda``: each test skips without a CUDA device. On a machine
with an H100, from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \\
      -p no:randomly tests/test_torch_card_ranks.py

Two module-scoped spawns over a file store (``parallel.launch.spawn``),
every rank on its own card over NCCL where the machine has one a rank,
else all on cuda:0 over gloo:

- 2 ranks of ``DistTrainer``: each rank's rows of one layer's
  ``maxk_spgemm`` and of GCN's ``spmm_t`` (forward and dx) bit-equal to
  one device's CBSR route; 3 float32 steps at dropout 0 within rtol 1e-5
  of one device's (rank 0's gradients after the first all-reduce within
  rtol 1e-5, atol 1e-6); 5 bf16 SAGE steps and 2 each of GCN and GNN_res
  (whose BatchNorm sums over the ranks), each step's launches a rank as
  ``DIST_RUNS`` says, finite losses and evaluation logits;
- 4 ranks as 2 graph x 2 model (``--model_parallel 2``; rank = graph
  rank * 2 + model rank), every Dense layer column-parallel: the same 3
  float32 steps within rtol 1e-5 of one device's, rank 0's slices of the
  gradients within rtol 1e-5, atol 1e-6; 3 bf16 steps launching as the
  2 SAGE ranks do, and an evaluation.

Beside them, the CLIs as a user runs them on the card: ``python -m
maxk_tpu_torch.train --n_devices 2`` and ``python -m
maxk_tpu_torch.bench.scaling_bench --devices 2 4 --model-parallel 2
--project``.

The ranks run this module's ``dist_rank`` and ``tp_rank``, which import
no JAX.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from card_inputs import NONE, card, cell, counts, since  # noqa: F401
from maxk_tpu_torch.train.loop import Trainer

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
# What one rank launches a step, by kernel id: SAGE's CBSR wire expands
# the table (K6) forward and the sampled gradient backward; GCN and
# GNN_res exchange dense rows; GNN_res's BatchNorm, a layer, takes both
# sums forward and backward, the affine pass and the input gradient.
SAGE_STEP = {"k1": 4, "k2": 8, "k3": 4, "k4": 4, "k6": 8}
GCN_STEP = {"k1": 4, "k2": 8}
DIST_RUNS = {"sage": (5, SAGE_STEP), "gcn": (2, GCN_STEP),
             "gnn_res": (2, {**GCN_STEP, "bn_sums": 8, "bn_affine": 4,
                             "bn_dx": 4})}
TP_GRID = (2, 2)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _steps(trainer, ds, n_steps: int) -> tuple:
    """n_steps train steps and an evaluation: ([(loss, launches)], whether
    the logits have the dataset's shape and are finite)."""
    steps = []
    for _ in range(n_steps):
        before = counts()
        steps.append((float(trainer.train_step()), since(before)))
    logits = trainer.eval_logits()
    return steps, bool(tuple(logits.shape) == (ds.csr.n_nodes,
                                               ds.num_classes)
                       and torch.isfinite(logits).all())


def _f32_losses(trainer, out: dict, grads: bool) -> None:
    """3 steps of a float32, dropout-0 trainer into out["f32_losses"], and
    the first step's gradients into out["f32_grads"] if `grads`."""
    out["f32_losses"] = [float(trainer.train_step())]
    if grads:
        out["f32_grads"] = {n: p.grad.cpu().numpy()
                            for n, p in trainer.model.named_parameters()}
    out["f32_losses"] += [float(trainer.train_step()) for _ in range(2)]


def dist_rank(group, job: dict) -> dict:
    """One rank of 2 (run by parallel.launch.spawn): one layer's
    aggregation against one device's, 3 float32 steps, then DIST_RUNS."""
    _no_tf32()
    from maxk_tpu_torch.models.models import GraphBundle
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm
    from maxk_tpu_torch.ops.spmm import spmm_t
    from maxk_tpu_torch.parallel.dist_train import DistTrainer
    from maxk_tpu_torch.parallel.partition import local_bundle, shard_bundle
    ds, cfg, k = job["ds"], job["cfg"], job["cfg"]["maxk"]
    dev, rank = group.device, group.rank
    out = dict(rank=rank, backend=group.backend)
    mean = shard_bundle(ds.csr, group.size, ("mean",), symmetric=True)
    sym = shard_bundle(ds.csr, group.size, ("sym",), symmetric=True)
    local, local_sym = local_bundle(mean, group), local_bundle(sym, group)

    # One layer's aggregation, forward and dx: this rank's rows against
    # the single-device CBSR route's on the whole graph (bf16 compute).
    single = GraphBundle.from_csr(ds.csr, norms=("mean", "sym"),
                                  symmetric=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    d = ds.features.shape[1]
    x = torch.randn(ds.csr.n_nodes, d, device=dev, generator=gen)
    dy = torch.randn(ds.csr.n_nodes, d, device=dev, generator=gen)
    rows = slice(rank * mean.rows_per_shard,
                 (rank + 1) * mean.rows_per_shard)

    def layer(fn, g, g_t, xs, dys):
        xg = xs.clone().requires_grad_(True)
        y = fn(g, g_t, xg)
        y.backward(dys)
        return y.detach(), xg.grad

    def spgemm(g, g_t, xg):
        return maxk_spgemm(g, g_t, xg, k)

    os.environ["MAXK_FUSED_MASK"] = "0"
    want = {"maxk_spgemm": layer(spgemm, single.g_mean, single.g_mean_t,
                                 x, dy),
            "spmm_sym": layer(spmm_t, single.g_sym, single.g_sym_t, x, dy)}
    del os.environ["MAXK_FUSED_MASK"]
    got = {"maxk_spgemm": layer(spgemm, local.g_mean, local.g_mean_t,
                                x[rows], dy[rows]),
           "spmm_sym": layer(spmm_t, local_sym.g_sym, local_sym.g_sym_t,
                             x[rows], dy[rows])}
    out["bit_equal"] = {
        f"{name}_{part}": bool(torch.equal(
            got[name][i].view(torch.int32),
            want[name][i][rows].view(torch.int32)))
        for name in got for i, part in enumerate(("y", "dx"))}
    del single, want, got, x, dy

    _f32_losses(DistTrainer(types.SimpleNamespace(
        **{**cfg, "compute_dtype": "float32", "dropout": 0.0}), ds, group,
        sharded=mean), out, rank == 0)
    out["runs"] = {
        model: _steps(DistTrainer(
            types.SimpleNamespace(**{**cfg, "model": model}), ds, group,
            sharded=mean if model == "sage" else sym), ds, n_steps)
        for model, (n_steps, _) in DIST_RUNS.items()}
    return out


def tp_rank(group, job: dict) -> dict:
    """One rank of 4 as a (2 graph x 2 model) grid (run by
    parallel.launch.spawn): 3 float32 steps, then 3 bf16 steps and an
    evaluation."""
    _no_tf32()
    from maxk_tpu_torch.parallel.dist_train import DistTrainer
    from maxk_tpu_torch.parallel.mesh import make_grid
    from maxk_tpu_torch.parallel.partition import shard_bundle
    from maxk_tpu_torch.parallel.tensor import ColumnParallelLinear
    ds, cfg = job["ds"], {**job["cfg"], "model_parallel": TP_GRID[1]}
    grid = make_grid(group, TP_GRID[1])
    out = dict(rank=group.rank, backend=group.backend,
               graph=(grid.graph.rank, grid.graph.size),
               model=(grid.model.rank, grid.model.size))
    mean = shard_bundle(ds.csr, grid.graph.size, ("mean",), symmetric=True)
    f32 = DistTrainer(types.SimpleNamespace(
        **{**cfg, "compute_dtype": "float32", "dropout": 0.0}), ds, grid,
        sharded=mean)
    _f32_losses(f32, out, group.rank == 0)
    out["columns"] = {f"{n}.weight": (m.lo, m.hi)
                      for n, m in f32.model.named_modules()
                      if isinstance(m, ColumnParallelLinear)}
    del f32
    out["steps"], out["logits_ok"] = _steps(DistTrainer(
        types.SimpleNamespace(**cfg), ds, grid, sharded=mean), ds, 3)
    return out


@pytest.fixture(scope="module")
def one_device(cell):
    """3 float32 steps at dropout 0 of one device's Trainer: the losses,
    and the first step's gradients."""
    _no_tf32()
    out = {}
    _f32_losses(Trainer(types.SimpleNamespace(
        **{**vars(cell.cfg), "compute_dtype": "float32", "dropout": 0.0}),
        cell.ds, graphs=cell.bundle), out, True)
    torch.cuda.empty_cache()
    return out


def _spawn(rank_fn, n_ranks: int, cell) -> list:
    from maxk_tpu_torch.parallel.launch import spawn
    with tempfile.TemporaryDirectory() as tmp:
        return spawn(rank_fn, n_ranks, f"file://{tmp}/store", "cuda",
                     args=(dict(ds=cell.ds, cfg=vars(cell.cfg)),))


def _backend(n_ranks: int) -> str:
    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def _grads_err(grads: dict, ref: dict, columns: dict) -> dict:
    """Each gradient's largest |grad - ref| / (1e-6 + 1e-5 |ref|), ref
    cut to the rank's rows where `columns` names them."""
    assert grads.keys() == ref.keys()
    err = {}
    for n, g in ref.items():
        if n in columns:
            g = g[slice(*columns[n])]
        err[n] = float(np.max(np.abs(grads[n] - g)
                              / (1e-6 + 1e-5 * np.abs(g))))
    return err


def _launches_hold(steps: list, per_step: dict) -> None:
    for loss, launches in steps:
        assert math.isfinite(loss), steps
        assert launches == {**NONE, **per_step}, launches


@pytest.fixture(scope="module")
def dist(cell, one_device):
    return _spawn(dist_rank, 2, cell)


def test_two_ranks_run_over_their_backend(dist):
    assert [r["backend"] for r in dist] == [_backend(2)] * 2


def test_shard_rows_bit_equal_to_one_device(dist):
    for r in dist:
        assert all(r["bit_equal"].values()), (r["rank"], r["bit_equal"])


def test_two_ranks_f32_steps_equal_one_device(dist, one_device):
    for r in dist:
        np.testing.assert_allclose(r["f32_losses"], one_device["f32_losses"],
                                   rtol=1e-5, atol=0)
    err = _grads_err(dist[0]["f32_grads"], one_device["f32_grads"], {})
    assert max(err.values()) <= 1.0, err


@pytest.mark.parametrize("model", list(DIST_RUNS))
def test_two_ranks_bf16_steps(dist, model):
    n_steps, per_step = DIST_RUNS[model]
    for r in dist:
        steps, logits_ok = r["runs"][model]
        assert len(steps) == n_steps
        _launches_hold(steps, per_step)
        assert logits_ok


def test_train_cli_on_two_ranks(card, tmp_path):
    """python -m maxk_tpu_torch.train --n_devices 2: 2 ranks spawned by
    one process, two epochs."""
    cli = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.train", "--dataset",
         "synthetic", "--n_devices", "2", "--epochs", "2", "--save_every",
         "0", "--path", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    text = cli.stdout + cli.stderr
    assert cli.returncode == 0, text[-3000:]
    assert len(re.findall(r"Epoch \d+/\d+\| Loss ([\d.]+)", text)) == 2


@pytest.fixture(scope="module")
def tp(cell, one_device):
    return _spawn(tp_rank, TP_GRID[0] * TP_GRID[1], cell)


def test_tp_grid_places_and_backend(tp):
    for r in tp:
        assert r["backend"] == _backend(4)
        assert r["graph"] == (r["rank"] // TP_GRID[1], TP_GRID[0])
        assert r["model"] == (r["rank"] % TP_GRID[1], TP_GRID[1])


def test_tp_f32_steps_equal_one_device(tp, one_device):
    for r in tp:
        np.testing.assert_allclose(r["f32_losses"], one_device["f32_losses"],
                                   rtol=1e-5, atol=0)
    err = _grads_err(tp[0]["f32_grads"], one_device["f32_grads"],
                     tp[0]["columns"])
    assert max(err.values()) <= 1.0, err


def test_tp_bf16_steps(tp):
    for r in tp:
        _launches_hold(r["steps"], SAGE_STEP)
        assert r["logits_ok"]


def test_scaling_bench_cli(card):
    """The sweep on the card: one spawn a size, one row and one projection
    a size."""
    sweep = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.bench.scaling_bench",
         "--devices", "2", "4", "--model-parallel", "2", "--project"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    text = sweep.stdout + sweep.stderr
    assert sweep.returncode == 0, text[-3000:]
    lines = [json.loads(x) for x in sweep.stdout.splitlines()
             if x.startswith("{")]
    rows = [x for x in lines if "step_ms" in x]
    assert [x["devices"] for x in rows] == [2, 4]
    assert all(math.isfinite(x["loss"]) for x in rows)
    assert sum("projection" in x for x in lines) == 2
