"""Tensor parallelism in the port on a (2 graph x 2 model) grid, vs one
device and vs maxk_tpu.

One module-scoped spawn of 4 gloo ranks on the CPU, meeting at a file
store in a temporary directory, runs ``torch_dist_ranks.run_grid``: the
ranks form a ``ProcessGrid`` (rank = graph rank * 2 + model rank), and
every Dense layer is column-parallel over the model axis.

- ``DistTrainer``'s 3 losses for SAGE, GCN, GIN and GNN_res (norm on) at
  dropout 0 and float32 are within rtol 1e-5 of ``Trainer``'s, and each
  rank's gradients after the first all-reduce within rtol 1e-5, atol
  1e-6 of one device's (its rows of each Dense weight's). V = 301 pads
  the last shard; hidden 16 splits 8 + 8, the 5 classes 3 + 2;
- 1-layer SAGE from the JAX package's init (``params_from_flax``, each
  rank its own columns) is within rtol 1e-4 of the JAX ``DistTrainer`` on
  ``make_graph_mesh(4, model_axis_size=2)`` over the conftest's virtual
  devices, at V = 256 and 4 classes, which the model axis divides, as
  JAX's placement needs (``tests/test_parallel.py``'s model-parallel
  test mirrored);
- the placement (JAX's ``assert_state_placement``): each rank's Dense
  weights, their Adam moments and Lookahead slow copies hold its rows,
  every other leaf is whole, and the state's bytes are below one
  device's;
- a checkpoint written after 2 steps at dropout 0.5 holds whole weights
  and resumes to the uninterrupted run's third loss.

Beside the spawn: the CLI trains on a (2 x 2) grid; the NVLink
projection (``bench/roofline.py::project_multichip``) gives the JAX
projection's numbers from the same compute ms, halo rows, dim, k and
rate; ``python -m maxk_tpu_torch.bench.scaling_bench`` runs a (1 x 2)
grid on the CPU.
"""

import contextlib
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.bench import roofline as jax_roofline
from maxk_tpu.data.datasets import make_synthetic_dataset as jax_dataset
from maxk_tpu.parallel.dist_train import DistTrainer as JaxDistTrainer
from maxk_tpu.parallel.mesh import MODEL_AXIS, make_graph_mesh
from maxk_tpu_torch.bench import roofline, scaling_bench
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.ops.graph import SegmentPlan
from maxk_tpu_torch.parallel.launch import spawn
from maxk_tpu_torch.parallel.mesh import split_bounds, split_sizes
from maxk_tpu_torch.parallel.partition import shard_graph
from maxk_tpu_torch.train.__main__ import main as cli_main
from maxk_tpu_torch.train.loop import model_from_config

import torch_dist_ranks
from test_torch_dist import (MODELS, RANK_THREADS, _plain,
                             check_against_one_device, one_device,
                             weight_columns)

V = 301
JAX_V = 256
JAX_LAYERS = 1
GRID = (2, 2)


@dataclasses.dataclass
class _Cfg:
    model: str = "sage"
    hidden_dim: int = 16
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
    n_devices: int = 4
    model_parallel: int = 1


def _dataset_kw(n_nodes, n_classes=5):
    return dict(n_nodes=n_nodes, avg_degree=8.0, n_classes=n_classes,
                in_size=24, seed=3)


# The JAX package places a kernel as P(None, "model") only where the
# model axis divides its columns: its comparison has 4 classes.
JAX_DATASET = _dataset_kw(JAX_V, n_classes=4)


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX DistTrainer on a (2 graph, 2 model) mesh of virtual
    devices: its init and 3 losses."""
    mesh = make_graph_mesh(4, model_axis_size=2)
    assert mesh.shape[MODEL_AXIS] == 2
    tr = JaxDistTrainer(_Cfg(hidden_layers=JAX_LAYERS),
                        jax_dataset(**JAX_DATASET), mesh=mesh)
    assert (tr.n_shards, tr.model_parallel) == GRID
    state = tr.init_state()
    params = _plain(state.params)
    losses = []
    rng = jax.random.PRNGKey(0)
    for _ in range(3):
        state, loss = tr.train_step(state, rng)
        losses.append(float(loss))
    return params, losses


@pytest.fixture(scope="module")
def inputs(jax_tp, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return dict(config=dataclasses.asdict(_Cfg()),
                dataset=make_synthetic_dataset(**_dataset_kw(V)),
                jax_dataset=make_synthetic_dataset(**JAX_DATASET),
                flax_params=jax_tp[0], jax_layers=JAX_LAYERS,
                ckpt_dir=str(tmp / "ckpt"), store=str(tmp / "store"))


@contextlib.contextmanager
def rank_threads():
    """RANK_THREADS in the environment, which spawned ranks inherit."""
    saved = {k: os.environ.get(k) for k in RANK_THREADS}
    os.environ.update(RANK_THREADS)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def ranks(inputs):
    with rank_threads():
        return spawn(torch_dist_ranks.run_grid, 4,
                     f"file://{inputs['store']}", "cpu", args=(inputs,))


def test_grid_layout(ranks):
    """rank = graph rank * 2 + model rank, over gloo."""
    assert [(r["rank"], r["graph"], r["model"]) for r in ranks] == [
        (g * 2 + m, (g, 2), (m, 2)) for g in range(2) for m in range(2)]
    assert {r["backend"] for r in ranks} == {"gloo"}


@pytest.mark.parametrize("model", MODELS)
def test_grid_matches_trainer(ranks, inputs, model):
    cfg = _Cfg(model=model)
    want = one_device(cfg, inputs["dataset"])
    for r in ranks:
        check_against_one_device(
            r["trainers"][model], want,
            weight_columns(cfg, inputs["dataset"], r["model"][0], 2))
    assert want["losses"][-1] < want["losses"][0]


def test_grid_sage_from_flax_matches_jax_tp(ranks, jax_tp):
    for r in ranks:
        np.testing.assert_allclose(r["from_jax"], jax_tp[1], rtol=1e-4)


def test_state_placement(ranks, inputs):
    """Each rank's Dense weights and their Adam moments and Lookahead
    copies are its ceil or floor of dout / 2 rows; the rest is whole."""
    full = model_from_config(_Cfg(), inputs["dataset"])
    whole = dict(full.named_parameters())
    linear = {f"{n}.weight" for n, m in full.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for r in ranks:
        pl = r["placement"]
        assert pl["shapes"].keys() == whole.keys()
        assert set(pl["columns"]) == linear
        m = r["model"][0]
        for name, shapes in pl["shapes"].items():
            want = tuple(whole[name].shape)
            if name in linear:
                dout = want[0]
                lo, hi, n = pl["columns"][name]
                assert n == dout and hi - lo == [-(-dout // 2),
                                                 dout // 2][m]
                want = (hi - lo,) + want[1:]
            assert set(shapes.values()) == {want}, (name, shapes)
        # Parameters, 2 Adam moments and the slow copy, 4 bytes each.
        local = sum(int(np.prod(s["param"])) for s in pl["shapes"].values())
        assert pl["nbytes"] == 4 * 4 * local
        assert local < 0.6 * sum(p.numel() for p in whole.values())
    a, b = (r["placement"]["columns"]["lin_out.weight"] for r in ranks[:2])
    assert (a, b) == ((0, 3, 5), (3, 5, 5))


def test_grid_checkpoint_resume(ranks, inputs):
    assert os.listdir(inputs["ckpt_dir"]) == ["ckpt_2.pt"]
    full = model_from_config(_Cfg(), inputs["dataset"])
    for r in ranks:
        res = r["resume"]
        assert (res["step"], res["epoch"]) == (2, 3)
        assert res["resumed"] == res["straight"][2]
        # The checkpoint holds whole weights, whatever the grid.
        assert res["blob_shapes"] == {k: tuple(v.shape) for k, v in
                                      full.state_dict().items()}
    logits = [r["resume"]["logits"] for r in ranks]
    assert logits[0].shape == (V, 5)
    assert all(np.array_equal(logits[0], x) for x in logits[1:])


def test_cli_trains_on_grid(tmp_path):
    with rank_threads():
        res = cli_main(["--dataset", "synthetic", "--device", "cpu",
                        "--n_devices", "4", "--model_parallel", "2",
                        "--epochs", "2", "--hidden_dim", "16",
                        "--hidden_layers", "2", "--maxk", "8",
                        "--compute_dtype", "float32", "--save_every", "0",
                        "--path", str(tmp_path)])
    assert res.epochs_run == 2
    assert all(math.isfinite(h["loss"]) for h in res.history)
    log = (tmp_path / "synthetic.log").read_text()
    assert "4 ranks (2-way graph x 2-way model) over gloo" in log


@pytest.mark.parametrize("n,parts", [(41, 2), (5, 2), (256, 4), (3, 4)])
def test_split_matches_tensor_split(n, parts):
    """The model axis splits a width as torch.tensor_split does (the first
    n % parts ranks one more; a rank may hold none), and each rank's
    bounds tile [0, n)."""
    want = [len(c) for c in torch.tensor_split(torch.arange(n), parts)]
    assert split_sizes(n, parts) == want
    bounds = [split_bounds(n, parts, i) for i in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert [hi - lo for lo, hi in bounds] == want


@pytest.mark.parametrize("n_shards,slots,halo_rows,dim,k", [
    (1, 3500, 0, 256, 32), (2, 1800, 37, 256, 32), (4, 1000, 41, 255, 16),
    (8, 600, 300, 64, 8)])
def test_projection_matches_jax(n_shards, slots, halo_rows, dim, k):
    """The same compute ms (the JAX model's slots x its per-slot cost),
    halo rows, dim, k and link rate give the JAX projection's dict."""
    ns_d256 = 2.8
    lanes = -(-dim // 2)
    per_slot = ns_d256 * lanes / 128.0
    want = jax_roofline.project_multichip(
        n_shards=n_shards, slots_per_shard=slots, slots_single=3500,
        halo_rows=halo_rows, dim=dim, k=k, n_aggregations=6,
        ici_gbps=roofline.NVLINK_GBPS, ns_per_slot_d256=ns_d256)
    got = roofline.project_multichip(
        n_shards=n_shards, compute_ms_per_agg=slots * per_slot * 1e-6,
        compute1_ms_per_agg=3500 * per_slot * 1e-6, halo_rows=halo_rows,
        dim=dim, k=k, n_aggregations=6)
    assert got == want


def test_sharded_k2_bytes(graph_kw=dict(n_nodes=301, avg_degree=8.0,
                                        n_classes=5, in_size=24, seed=3)):
    """One shard's bytes are the whole graph's; each of several shards
    moves fewer, and the largest is what the projection takes."""
    csr = make_synthetic_dataset(**graph_kw).csr.normalize("mean")
    whole = roofline.k2_bytes(csr.n_nodes, csr.n_edges, 64,
                              SegmentPlan.build(csr))
    assert roofline.sharded_k2_bytes(shard_graph(csr, 1), 64) == whole
    assert whole > csr.n_edges * 64 * 2
    sg = shard_graph(csr, 4)
    per = [roofline.k2_bytes(g.n_nodes, g.n_edges, 64, SegmentPlan.build(g))
           for g in sg.shards]
    assert roofline.sharded_k2_bytes(sg, 64) == max(per) < whole


def test_scaling_bench_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    with rank_threads():
        rc = scaling_bench.main(
            ["--device", "cpu", "--devices", "2", "--model-parallel", "2",
             "--project", "--n-nodes", "256", "--steps", "1", "--json",
             str(out)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    (row,) = [x for x in lines if "step_ms" in x]
    assert (row["devices"], row["graph_shards"], row["model_parallel"]) \
        == (2, 1, 2)
    assert math.isfinite(row["loss"]) and row["step_ms"] > 0
    assert (row["speedup"], row["efficiency"]) == (1.0, 1.0)
    (proj,) = [x["projection"] for x in lines if "projection" in x]
    assert proj["n_shards"] == 1 and proj["comm_cbsr_ms_per_agg"] == 0
    assert proj["k2_rate"].startswith("measured on 2 ranks")
    assert proj["dense"]["speedup_serial"] == 1.0
    assert json.loads(out.read_text())["sweep"] == [row]
