"""Row-partitioned training in the port vs one device and vs maxk_tpu.

One module-scoped spawn of 2 gloo ranks on the CPU, meeting at a file
store in a temporary directory (so test workers cannot collide on a
port), runs ``torch_dist_ranks.run`` and returns each rank's results:

- sharded ``spmm_t`` and ``maxk_spgemm`` (forward and dx) in halo and
  all-gather mode are bit-equal to the single-device port at float32,
  and so is ``maxk_spgemm`` at bfloat16, whose halo rows cross on the
  packed wire (bf16 values, uint8 selectors); the single-device side
  runs the CBSR route, which a shard always takes; under
  ``CBSR_GATHER_MODE`` the all-gather mode's ``maxk_spgemm`` (K5 on the
  gathered table) is bit-equal to one device's under the flag;
- ``DistTrainer``'s 3 losses for SAGE, GCN, GIN and GNN_res (norm on) at
  dropout 0 and float32 are within rtol 1e-5 of ``Trainer``'s, and so
  are the gradients after the first all-reduce (atol 1e-6). V = 301
  pads the last shard, whose padded row GNN_res's BatchNorm leaves out;
- the same 2 ranks as a (1 graph x 2 model) grid (tensor parallelism,
  ``--model_parallel 2``) give the same losses, and each rank's rows of
  every Dense weight's gradient are one device's rows;
- 1-layer SAGE from the JAX package's init (``params_from_flax``) is
  within rtol 1e-4 (``test_torch_train.py``'s) of the JAX
  ``DistTrainer`` on a 2-device mesh of the conftest's virtual devices,
  at V = 256, where the JAX package pads no row;
- a checkpoint written after 2 steps at dropout 0.5 resumes to the
  uninterrupted run's third loss.
- under the profiler each rank's step holds the spans of
  ``maxk_tpu_torch/obs.py``: forward, backward, the all-reduce and the
  optimizer inside ``maxk.step``.

The CLI's 2-process ``--distributed`` split gives the same loss lines as
1 process of 2 ranks (``tests/test_multihost.py`` mirrored).
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.data.datasets import make_synthetic_dataset as jax_dataset
from maxk_tpu.parallel.dist_train import DistTrainer as JaxDistTrainer
from maxk_tpu.parallel.mesh import make_graph_mesh
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.ops import spgemm as spgemm_module
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.ops.spmm import spmm_dense_oracle, spmm_t
from maxk_tpu_torch.parallel.launch import spawn
from maxk_tpu_torch.train import metrics
from maxk_tpu_torch.train.loop import Trainer

import torch_dist_ranks
from conftest import random_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 301
K = 4


@dataclasses.dataclass
class _Cfg:
    model: str = "sage"
    hidden_dim: int = 32
    hidden_layers: int = 2
    dropout: float = 0.0
    norm: bool = True
    nonlinear: str = "maxk"
    maxk: int = 8
    w_lr: float = 0.01
    w_weight_decay: float = 0.0
    enable_lookahead: bool = False
    seed: int = 97
    compute_dtype: str = "float32"
    device: str = "cpu"
    halo: bool = True
    n_devices: int = 2
    model_parallel: int = 1


def _dataset_kw(n_nodes):
    return dict(n_nodes=n_nodes, avg_degree=8.0, n_classes=5, in_size=24,
                seed=3)


def _plain(tree):
    """flax params as nested dicts of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


# The JAX comparison's model: one layer keeps its compile short.
JAX_LAYERS = 1


@pytest.fixture(scope="module")
def jax_sage():
    """The JAX DistTrainer on 2 virtual devices: its init and 3 losses."""
    cfg = _Cfg(hidden_layers=JAX_LAYERS)
    tr = JaxDistTrainer(cfg, jax_dataset(**_dataset_kw(256)),
                        mesh=make_graph_mesh(2))
    state = tr.init_state()
    params = _plain(state.params)
    losses = []
    rng = jax.random.PRNGKey(0)
    for _ in range(3):
        state, loss = tr.train_step(state, rng)
        losses.append(float(loss))
    return params, losses


@pytest.fixture(scope="module")
def graph():
    g = random_graph(V, 8.0, seed=4, power_law=True)
    return CSRGraph(g.indptr, g.indices, g.values)


@pytest.fixture(scope="module")
def inputs(graph, jax_sage, tmp_path_factory):
    rng = np.random.default_rng(8)
    tmp = tmp_path_factory.mktemp("dist")
    return dict(
        graph=(graph.indptr, graph.indices, graph.values),
        x=rng.normal(size=(V, 16)).astype(np.float32),
        dy=rng.normal(size=(V, 16)).astype(np.float32), k=K,
        config=dataclasses.asdict(_Cfg()),
        dataset=make_synthetic_dataset(**_dataset_kw(V)),
        jax_dataset=make_synthetic_dataset(**_dataset_kw(256)),
        flax_params=jax_sage[0], jax_layers=JAX_LAYERS,
        ckpt_dir=str(tmp / "ckpt"),
        store=str(tmp / "store"))


# Each rank's torch threads: the graphs are tiny, and the test workers
# share the host's cores.
RANK_THREADS = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def ranks(inputs):
    saved = {k: os.environ.get(k) for k in RANK_THREADS}
    os.environ.update(RANK_THREADS)      # the spawned ranks inherit it
    try:
        return spawn(torch_dist_ranks.run, 2, f"file://{inputs['store']}",
                     "cpu", args=(inputs,))
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _rows(ranks, pick):
    return np.concatenate([pick(r) for r in ranks])[:V]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_ranks_ran_on_gloo(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {r["backend"] for r in ranks} == {"gloo"}


def test_dist_step_spans(ranks):
    """Each rank's step: ``maxk.step`` holding forward, backward, the
    gradients' all-reduce and the optimizer, in that order."""
    for r in ranks:
        (lo, hi, name), *children = r["spans"]
        assert name == "maxk.step"
        assert [n for _, _, n in children] == [
            "maxk.step.forward", "maxk.step.backward",
            "maxk.step.allreduce", "maxk.step.optimizer"]
        last = lo
        for s, e, _ in children:
            assert last <= s <= e <= hi
            last = e


@pytest.mark.parametrize("halo", [True, False], ids=["halo", "gather"])
@pytest.mark.parametrize("name,cd", [("spmm", "float32"),
                                     ("spgemm", "float32"),
                                     ("spgemm", "bfloat16")])
def test_sharded_ops_bit_equal_one_device(ranks, inputs, graph, monkeypatch,
                                          name, cd, halo):
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    g = DeviceCSR.from_csr(graph, "cpu")
    g_t = DeviceCSR.from_csr(graph.transpose(), "cpu")
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y = (spmm_t(g, g_t, x, cd) if name == "spmm"
         else maxk_spgemm(g, g_t, x, K, cd))
    y.backward(torch.from_numpy(inputs["dy"]))
    key = (name, cd, halo)
    np.testing.assert_array_equal(
        _bits(_rows(ranks, lambda r: r["ops"][key][0])),
        _bits(y.detach().numpy()))
    np.testing.assert_array_equal(
        _bits(_rows(ranks, lambda r: r["ops"][key][1])),
        _bits(x.grad.numpy()))


@pytest.mark.parametrize("halo", [True, False], ids=["halo", "gather"])
def test_sharded_int8_spmm(ranks, inputs, graph, halo):
    """spmm_t under "int8" on shards (tests/test_parallel.py's int8 case
    mirrored): each rank quantizes the table its exchange builds, so the
    scale covers the received rows. The all-gather table is every row,
    so its rows are bit-equal to one device's; the halo table is the
    rank's and its halo rows, so its rows are held, as the JAX test holds
    them, to the dense oracle: mean error over max(1, mean |ref|) < 0.02,
    forward and dx."""
    g = DeviceCSR.from_csr(graph, "cpu")
    g_t = DeviceCSR.from_csr(graph.transpose(), "cpu")
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y = spmm_t(g, g_t, x, "int8")
    y.backward(torch.from_numpy(inputs["dy"]))
    key = ("spmm", "int8", halo)
    y_r = _rows(ranks, lambda r: r["ops"][key][0])
    dx_r = _rows(ranks, lambda r: r["ops"][key][1])
    if not halo:
        np.testing.assert_array_equal(_bits(y_r), _bits(y.detach().numpy()))
        np.testing.assert_array_equal(_bits(dx_r), _bits(x.grad.numpy()))
    for out, a, t in ((y_r, graph, inputs["x"]),
                      (dx_r, graph.transpose(), inputs["dy"])):
        ref = spmm_dense_oracle(a, t)
        err = np.abs(out - ref)
        assert err.mean() / max(1.0, np.abs(ref).mean()) < 0.02


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_sharded_gather_mode_bit_equal_one_device(ranks, inputs, graph,
                                                  monkeypatch, cd):
    """CBSR_GATHER_MODE in all-gather mode: each shard's K5 reads the
    gathered table; its rows equal one device's under the flag."""
    monkeypatch.setattr(spgemm_module, "CBSR_GATHER_MODE", True)
    g = DeviceCSR.from_csr(graph, "cpu")
    g_t = DeviceCSR.from_csr(graph.transpose(), "cpu")
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y = maxk_spgemm(g, g_t, x, K, cd)
    y.backward(torch.from_numpy(inputs["dy"]))
    key = ("spgemm_gather", cd, False)
    np.testing.assert_array_equal(
        _bits(_rows(ranks, lambda r: r["ops"][key][0])),
        _bits(y.detach().numpy()))
    np.testing.assert_array_equal(
        _bits(_rows(ranks, lambda r: r["ops"][key][1])),
        _bits(x.grad.numpy()))


MODELS = ["sage", "gcn", "gin", "gnn_res"]


def one_device(cfg, dataset) -> dict:
    """Trainer's 3 losses, and its gradients after the first step."""
    tr = Trainer(cfg, dataset)
    losses = [float(tr.train_step())]
    grads = {n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()}
    losses += [float(tr.train_step()) for _ in range(2)]
    return dict(losses=losses, grads=grads)


@pytest.fixture(scope="module")
def single(inputs) -> dict:
    """One device's run of each family, for the 2 ranks and the grid."""
    return {m: one_device(_Cfg(model=m), inputs["dataset"]) for m in MODELS}


def check_against_one_device(got: dict, want: dict, columns=None) -> None:
    """3 losses within rtol 1e-5 of one device's, and the gradients after
    the first all-reduce within rtol 1e-5, atol 1e-6; on a grid each
    column-parallel weight's gradient is one device's rows
    ``columns[name]`` = (lo, hi)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["grads"].keys() == want["grads"].keys()
    for n, g in want["grads"].items():
        if columns and n in columns:
            g = g[slice(*columns[n])]
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("model", MODELS)
def test_dist_trainer_matches_trainer(ranks, single, model):
    for r in ranks:
        check_against_one_device(r["trainers"][model], single[model])
    losses = single[model]["losses"]
    assert losses[-1] < losses[0]


def weight_columns(cfg, dataset, rank: int, size: int) -> dict:
    """{weight name: (lo, hi)} of a model rank's rows of every Linear
    weight of cfg's model, split as torch.tensor_split splits them."""
    from maxk_tpu_torch.train.loop import model_from_config
    full = model_from_config(cfg, dataset)
    out = {}
    for name, m in full.named_modules():
        if isinstance(m, torch.nn.Linear):
            idx = torch.tensor_split(torch.arange(m.out_features), size)[rank]
            out[f"{name}.weight"] = (int(idx[0]), int(idx[-1]) + 1)
    return out


@pytest.mark.parametrize("model", MODELS)
def test_one_by_two_grid_matches_trainer(ranks, single, inputs, model):
    """The 2 ranks as (1 graph x 2 model): every Dense layer column-
    parallel, the 5 classes split 3 + 2."""
    for r in ranks:
        grid = r["grid"]
        assert grid["graph"] == (0, 1) and grid["model"] == (r["rank"], 2)
        assert grid["contiguous"]
        cols = weight_columns(_Cfg(model=model), inputs["dataset"],
                              r["rank"], 2)
        assert cols["lin_out.weight"] == [(0, 3), (3, 5)][r["rank"]]
        check_against_one_device(grid["trainers"][model], single[model],
                                 cols)


def test_dist_sage_matches_jax_dist_trainer(ranks, jax_sage):
    for r in ranks:
        np.testing.assert_allclose(r["from_jax"], jax_sage[1], rtol=1e-4)


def test_checkpoint_resume_gives_same_next_loss(ranks, inputs):
    assert os.listdir(inputs["ckpt_dir"]) == ["ckpt_2.pt"]
    for r in ranks:
        res = r["resume"]
        assert (res["step"], res["epoch"]) == (2, 3)
        assert res["extra"] == dict(note="two steps")
        assert res["resumed"] == res["straight"][2]
    # Every rank evaluates the same gathered logits.
    a, b = (r["resume"]["logits"] for r in ranks)
    assert a.shape == (V, 5) and np.array_equal(a, b)


def test_dist_evaluate_masks_uses_every_node(ranks, inputs):
    """Each rank's metrics count the whole graph's nodes, not its rows:
    the host path's triple on the gathered logits."""
    ds = inputs["dataset"]
    for r in ranks:
        want = tuple(
            metrics.evaluate_logits(r["resume"]["logits"], ds.labels, m,
                                    ds.metric)
            for m in (ds.train_mask, ds.val_mask, ds.test_mask))
        assert r["resume"]["metrics"] == want


_EPOCH_RE = re.compile(r"Epoch (\d+)/\d+\| Loss ([\d.]+) \| "
                       r"Train Accuracy ([\d.]+) \| Val Accuracy ([\d.]+)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_processes_match_one_process(tmp_path):
    """--n_devices 2 as 2 processes of 1 rank (--distributed) and as 1
    process of 2 ranks with --no_halo: the same loss lines."""
    base = [sys.executable, "-m", "maxk_tpu_torch.train", "--dataset",
            "synthetic", "--device", "cpu", "--hidden_layers", "2",
            "--hidden_dim", "32", "--maxk", "8", "--epochs", "2",
            "--save_every", "0", "--compute_dtype", "float32",
            "--n_devices", "2"]
    port = _free_port()
    runs = [base + ["--path", str(tmp_path / f"p{i}"), "--distributed",
                    "--num_processes", "2", "--process_id", str(i),
                    "--coordinator", f"127.0.0.1:{port}"]
            for i in range(2)]
    runs.append(base + ["--path", str(tmp_path / "one"), "--no_halo"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(RANK_THREADS)
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in runs]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    lines = [[m.groups() for m in _EPOCH_RE.finditer(o)] for o in outs]
    assert len(lines[0]) == 2 and lines[1] == []
    assert lines[0] == lines[2]
    assert "over gloo" in outs[0] and "all-gather" in outs[2]
