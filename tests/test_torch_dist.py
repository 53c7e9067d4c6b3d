"""Row-partitioned training in the port vs one device and vs maxk_tpu.

One module-scoped spawn of 2 gloo ranks on the CPU, meeting at a file
store in a temporary directory (so test workers cannot collide on a
port), runs ``torch_dist_ranks.run`` and returns each rank's results:

- sharded ``spmm_t`` and ``maxk_spgemm`` (forward and dx) in halo and
  all-gather mode are bit-equal to the single-device port at float32,
  and so is ``maxk_spgemm`` at bfloat16, whose halo rows cross on the
  packed wire (bf16 values, uint8 selectors); the single-device side
  runs the CBSR route, which a shard always takes;
- ``DistTrainer``'s 3 losses for SAGE, GCN, GIN and GNN_res (norm on) at
  dropout 0 and float32 are within rtol 1e-5 of ``Trainer``'s, and so
  are the gradients after the first all-reduce (atol 1e-6). V = 301
  pads the last shard, whose padded row GNN_res's BatchNorm leaves out;
- 1-layer SAGE from the JAX package's init (``params_from_flax``) is
  within rtol 1e-4 (``test_torch_train.py``'s) of the JAX
  ``DistTrainer`` on a 2-device mesh of the conftest's virtual devices,
  at V = 256, where the JAX package pads no row;
- a checkpoint written after 2 steps at dropout 0.5 resumes to the
  uninterrupted run's third loss.

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

from maxk_tpu.data.datasets import make_synthetic_dataset as jax_dataset
from maxk_tpu.parallel.dist_train import DistTrainer as JaxDistTrainer
from maxk_tpu.parallel.mesh import make_graph_mesh
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.ops.spmm import spmm_t
from maxk_tpu_torch.parallel.launch import spawn
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


@pytest.mark.parametrize("model", ["sage", "gcn", "gin", "gnn_res"])
def test_dist_trainer_matches_trainer(ranks, inputs, model):
    tr = Trainer(_Cfg(model=model), inputs["dataset"])
    losses = [float(tr.train_step())]
    grads = {n: p.grad.numpy() for n, p in tr.model.named_parameters()}
    losses += [float(tr.train_step()) for _ in range(2)]
    for r in ranks:
        got = r["trainers"][model]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert got["grads"].keys() == grads.keys()
        for n, want in grads.items():
            np.testing.assert_allclose(got["grads"][n], want, rtol=1e-5,
                                       atol=1e-6, err_msg=n)
    assert losses[-1] < losses[0]


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
