"""The port's GCN, GIN and GNNRes vs the flax models, with flax params
and batch_stats carried across by ``params_from_flax``.

Tolerances, as for SAGE (``test_torch_models.py``): at
compute_dtype=float32 the eval logits agree at rtol=1e-5, atol=1e-5, a
train-mode step's loss at rtol=1e-5 and its parameter gradients
(``gin_eps_{i}`` and ``gconv_bias_{i}`` included) at rtol=1e-4,
atol=1e-6; the MaxK masks are identical, so only summation orders
differ. GNNRes's running mean and variance agree with flax's mutated
``batch_stats`` at rtol=1e-6, atol=1e-7 after one and after three
train-mode passes. At compute_dtype=bfloat16 both packages round the
aggregation's input to bfloat16 and accumulate in float32; a row of x
that differs by one float32 rounding can round to another bfloat16, so
the eval logits are held to a mean absolute error < 1e-3
(``BASELINE.md``'s bf16 bound) and a max error < 2e-2. The 5-step loss
trajectory (float32, dropout 0, LayerNorm or BatchNorm on) agrees with
``maxk_tpu.train.loop.Trainer`` at rtol=1e-4.

Each flax configuration is jitted once (``refs``): one program gives a
train-mode step's loss, gradients and mutated batch_stats, and the eval
logits under those batch_stats.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.data.datasets import make_synthetic_dataset as jax_dataset
from maxk_tpu.models.models import (GraphBundle as JaxGraphBundle,
                                    build_model as jax_build_model)
from maxk_tpu.train.loop import Trainer as JaxTrainer
from maxk_tpu.train.loop import masked_loss as jax_masked_loss
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.models.convert import params_from_flax
from maxk_tpu_torch.models.models import BatchNorm, GraphBundle, build_model
from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.train.loop import Trainer, masked_loss

from conftest import random_graph

V, F_IN, HID, LAYERS, CLASSES, K = 160, 24, 32, 2, 5, 8
MODELS = ("gcn", "gin", "gnn_res")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    csr = random_graph(V, 6.0, seed=11, weighted=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(V, F_IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, V)
    mask = rng.uniform(size=V) < 0.6
    port_csr = CSRGraph(csr.indptr, csr.indices, csr.values)
    return csr, port_csr, x, labels, mask


@dataclasses.dataclass
class _Ref:
    """One flax configuration: its model and variables, a train-mode
    step's (loss, grads, mutated batch_stats), and the eval logits under
    the mutated batch_stats."""
    flax_model: object
    graphs: object
    params: dict
    batch_stats: dict
    loss: float
    grads: dict
    new_batch_stats: dict
    eval_logits: np.ndarray


class _Refs:
    """flax references, built and jitted once per configuration."""

    def __init__(self, data):
        self.data = data
        self._built = {}

    def get(self, name, norm, nonlinear, compute_dtype="float32"):
        key = (name, norm, nonlinear, compute_dtype)
        if key not in self._built:
            self._built[key] = self._build(*key)
        return self._built[key]

    def _build(self, name, norm, nonlinear, compute_dtype):
        csr, _, x, labels, mask = self.data
        flax_model = jax_build_model(
            name, F_IN, HID, LAYERS, CLASSES, maxk=K, feat_drop=0.0,
            norm=norm, nonlinear=nonlinear, compute_dtype=compute_dtype)
        graphs = JaxGraphBundle.for_model(csr, name)
        xj = jnp.asarray(x)
        variables = flax_model.init(jax.random.PRNGKey(3), graphs, xj)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})

        @jax.jit
        def run(params, batch_stats):
            def loss_fn(p):
                logits, mutated = flax_model.apply(
                    {"params": p, "batch_stats": batch_stats}, graphs, xj,
                    training=True, mutable=["batch_stats"])
                loss = jax_masked_loss(logits, jnp.asarray(labels),
                                       jnp.asarray(mask), False)
                return loss, mutated.get("batch_stats", {})

            (loss, new_bs), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            logits = flax_model.apply(
                {"params": params, "batch_stats": new_bs}, graphs, xj)
            return loss, grads, new_bs, logits

        loss, grads, new_bs, logits = run(params, batch_stats)
        return _Ref(flax_model, graphs, _np(params), _np(batch_stats),
                    float(loss), _np(grads), _np(new_bs), np.asarray(logits))


@pytest.fixture(scope="module")
def refs(data):
    return _Refs(data)


def _port(data, ref, name, norm, nonlinear, batch_stats,
          compute_dtype="float32"):
    model = build_model(name, F_IN, HID, LAYERS, CLASSES, maxk=K,
                        feat_drop=0.0, norm=norm, nonlinear=nonlinear,
                        compute_dtype=compute_dtype)
    model.load_flax_params(ref.params, batch_stats or None)
    return model, GraphBundle.for_model(data[1], name, device="cpu")


@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_eval_logits_match_flax(data, refs, name, norm, nonlinear):
    ref = refs.get(name, norm, nonlinear)
    # GNNRes with norm evaluates under the running statistics that one
    # train-mode pass left, not the initial 0 and 1.
    if name == "gnn_res" and norm:
        assert not np.allclose(ref.new_batch_stats["norm_0"]["var"], 1.0)
    model, graphs = _port(data, ref, name, norm, nonlinear,
                          ref.new_batch_stats)
    with torch.no_grad():
        out = model(graphs, torch.from_numpy(data[2]))
    np.testing.assert_allclose(out.numpy(), ref.eval_logits, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_one_step_gradients_match_flax(data, refs, name, norm, nonlinear):
    _, _, x, labels, mask = data
    ref = refs.get(name, norm, nonlinear)
    model, graphs = _port(data, ref, name, norm, nonlinear, ref.batch_stats)
    logits = model(graphs, torch.from_numpy(x), training=True)
    loss = masked_loss(logits, torch.from_numpy(labels),
                       torch.from_numpy(mask), False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref.loss, rtol=1e-5)
    expected = params_from_flax(ref.grads)
    named = dict(model.named_parameters())
    assert sorted(expected) == sorted(named)
    own = "gin_eps_0" if name == "gin" else "gconv_bias_0"
    assert own in named and float(named[own].grad.abs().max()) > 0
    for key, g in expected.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_batchnorm_running_stats_match_flax(data):
    """After one and after three train-mode passes (on x scaled anew each
    pass), GNNRes's running buffers are flax's mutated batch_stats. An
    unbiased variance or torch's momentum convention would miss."""
    csr, port_csr, x, _, _ = data
    flax_model = jax_build_model("gnn_res", F_IN, HID, LAYERS, CLASSES,
                                 maxk=K, feat_drop=0.0, norm=True,
                                 compute_dtype="float32")
    graphs = JaxGraphBundle.for_model(csr, "gnn_res")
    variables = flax_model.init(jax.random.PRNGKey(3), graphs,
                                jnp.asarray(x))
    params, batch_stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def train_pass(batch_stats, xj):
        _, mutated = flax_model.apply(
            {"params": params, "batch_stats": batch_stats}, graphs, xj,
            training=True, mutable=["batch_stats"])
        return mutated["batch_stats"]

    model = build_model("gnn_res", F_IN, HID, LAYERS, CLASSES, maxk=K,
                        feat_drop=0.0, norm=True, compute_dtype="float32")
    model.load_flax_params(_np(params), _np(batch_stats))
    port_graphs = GraphBundle.for_model(port_csr, "gnn_res", device="cpu")
    for n_pass in range(1, 4):
        xp = x * (1.0 + 0.5 * n_pass)
        batch_stats = train_pass(batch_stats, jnp.asarray(xp))
        with torch.no_grad():
            model(port_graphs, torch.from_numpy(xp), training=True)
        if n_pass in (1, 3):
            state = model.state_dict()
            for key, value in params_from_flax({}, _np(batch_stats)).items():
                np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{key} after {n_pass}")


@pytest.mark.parametrize("name", MODELS)
def test_bf16_eval_logits_match_flax(data, refs, name):
    ref = refs.get(name, True, "maxk", "bfloat16")
    model, graphs = _port(data, ref, name, True, "maxk",
                          ref.new_batch_stats, compute_dtype="bfloat16")
    with torch.no_grad():
        out = model(graphs, torch.from_numpy(data[2])).numpy()
    err = np.abs(out - ref.eval_logits)
    assert err.mean() < 1e-3 and err.max() < 2e-2, (err.mean(), err.max())


@dataclasses.dataclass
class _Cfg:
    dataset: str = "synthetic"
    model: str = "gcn"
    hidden_dim: int = 32
    hidden_layers: int = 2
    dropout: float = 0.0
    norm: bool = True
    nonlinear: str = "maxk"
    maxk: int = 8
    epochs: int = 5
    w_lr: float = 0.01
    w_weight_decay: float = 0.0
    enable_lookahead: bool = False
    seed: int = 97
    selfloop: bool = False
    path: str = ""
    compute_dtype: str = "float32"
    device: str = "cpu"


@pytest.mark.parametrize("name", MODELS)
def test_loss_trajectory_matches_jax(tmp_path, name):
    kw = dict(n_nodes=300, avg_degree=8.0, n_classes=5, in_size=24, seed=3)
    cfg = _Cfg(model=name, path=str(tmp_path))
    ref = JaxTrainer(cfg, jax_dataset(**kw))
    state = ref.init_state()
    tr = Trainer(cfg, make_synthetic_dataset(**kw))
    tr.model.load_flax_params(_np(state.params),
                              _np(state.batch_stats) or None)
    ref_losses, losses = [], []
    rng = jax.random.PRNGKey(0)
    for _ in range(cfg.epochs):
        state, loss = ref._jit_step(state, rng)
        ref_losses.append(float(loss))
        losses.append(float(tr.train_step()))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", MODELS)
def test_parameter_names_match_flax(refs, name):
    ref = refs.get(name, True, "maxk")
    model = build_model(name, F_IN, HID, LAYERS, CLASSES, maxk=K, norm=True)
    assert sorted(params_from_flax(ref.params, ref.batch_stats)) == \
        sorted(model.state_dict())
    norm = model.norm_0
    if name == "gnn_res":
        assert isinstance(norm, BatchNorm)
        assert (norm.momentum, norm.eps) == (0.99, 1e-5)
    else:
        assert norm.eps == 1e-6


def test_params_from_flax_loads_top_level_leaves(refs):
    for name, leaf in (("gcn", "gconv_bias_1"), ("gin", "gin_eps_1")):
        params = dict(refs.get(name, False, "maxk").params)
        params[leaf] = np.full(np.shape(params[leaf]), 0.25, np.float32)
        model = build_model(name, F_IN, HID, LAYERS, CLASSES, maxk=K)
        model.load_flax_params(params)
        value = getattr(model, leaf)
        assert value.shape == np.shape(params[leaf])
        assert torch.all(value == 0.25)


def test_params_from_flax_loads_batch_stats(refs):
    ref = refs.get("gnn_res", True, "maxk")
    model = build_model("gnn_res", F_IN, HID, LAYERS, CLASSES, maxk=K,
                        norm=True)
    model.load_flax_params(ref.params, ref.new_batch_stats)
    for i in range(LAYERS):
        stats = ref.new_batch_stats[f"norm_{i}"]
        norm = getattr(model, f"norm_{i}")
        assert np.array_equal(norm.running_mean.numpy(), stats["mean"])
        assert np.array_equal(norm.running_var.numpy(), stats["var"])
    # Without batch_stats, the running statistics stay as they were.
    model.load_flax_params(ref.params)
    assert np.array_equal(model.norm_0.running_var.numpy(),
                          ref.new_batch_stats["norm_0"]["var"])


def test_params_from_flax_unknown_leaves_raise(refs):
    ref = refs.get("gnn_res", True, "maxk")
    with pytest.raises(ValueError, match="gconv_scale_0"):
        params_from_flax(dict(ref.params, gconv_scale_0=np.zeros(3)))
    with pytest.raises(ValueError, match="norm_0/gamma"):
        params_from_flax(dict(ref.params, norm_0=dict(ref.params["norm_0"],
                                                     gamma=np.ones(3))))
    with pytest.raises(ValueError, match="norm_1/count"):
        params_from_flax(ref.params, dict(
            ref.batch_stats, norm_1=dict(ref.batch_stats["norm_1"],
                                         count=np.ones(()))))
