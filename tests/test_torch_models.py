"""The port's SAGE models vs the flax models, with flax params carried
across by ``params_from_flax``.

At compute_dtype=float32 the eval logits agree at rtol=1e-5, atol=1e-5
and one step's parameter gradients at rtol=1e-4 (atol 1e-6): the MaxK
masks are identical, so only summation orders (SpMM, matmul, LayerNorm
statistics) differ.

The same holds on the CBSR route of the fused aggregation, which
MAXK_FUSED_MASK=0 selects in both packages: the ``cbsr_env`` fixture sets
it before any flax model is traced and clears JAX's caches around the
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.models.models import (GraphBundle as JaxGraphBundle,
                                    build_model as jax_build_model)
from maxk_tpu.train.loop import masked_loss as jax_masked_loss
from maxk_tpu_torch.models.convert import params_from_flax
from maxk_tpu_torch.models.models import GraphBundle, build_model
from maxk_tpu_torch.ops import spgemm as spgemm_mod
from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.train.loop import masked_loss

from conftest import random_graph

V, F_IN, HID, LAYERS, CLASSES, K = 160, 24, 32, 2, 5, 8


@pytest.fixture(scope="module")
def data():
    csr = random_graph(V, 6.0, seed=11, weighted=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(V, F_IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, V)
    mask = rng.uniform(size=V) < 0.6
    port_csr = CSRGraph(csr.indptr, csr.indices, csr.values)
    return csr, port_csr, x, labels, mask


def _models(name, norm, nonlinear, feat_drop=0.0):
    kw = dict(maxk=K, feat_drop=feat_drop, norm=norm, nonlinear=nonlinear,
              compute_dtype="float32")
    return (jax_build_model(name, F_IN, HID, LAYERS, CLASSES, **kw),
            build_model(name, F_IN, HID, LAYERS, CLASSES, **kw))


def _init_pair(data, name, norm, nonlinear):
    csr, port_csr, x, _, _ = data
    flax_model, model = _models(name, norm, nonlinear)
    graphs = JaxGraphBundle.for_model(csr, name)
    params = flax_model.init(jax.random.PRNGKey(3), graphs,
                             jnp.asarray(x))["params"]
    model.load_flax_params(jax.tree.map(np.asarray, params))
    port_graphs = GraphBundle.for_model(port_csr, name, device="cpu")
    return flax_model, graphs, params, model, port_graphs


@pytest.fixture
def cbsr_env(monkeypatch):
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _check_eval_logits(data, name, norm, nonlinear):
    x = data[2]
    flax_model, graphs, params, model, port_graphs = _init_pair(
        data, name, norm, nonlinear)
    ref = flax_model.apply({"params": params}, graphs, jnp.asarray(x))
    with torch.no_grad():
        out = model(port_graphs, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _check_one_step_gradients(data, name, norm):
    _, _, x, labels, mask = data
    flax_model, graphs, params, model, port_graphs = _init_pair(
        data, name, norm, "maxk")

    def loss_fn(p):
        logits = flax_model.apply({"params": p}, graphs, jnp.asarray(x),
                                  training=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_masked_loss(logits, jnp.asarray(labels),
                               jnp.asarray(mask), False)

    loss_ref, grads = jax.value_and_grad(loss_fn)(params)
    logits = model(port_graphs, torch.from_numpy(x), training=True)
    loss = masked_loss(logits, torch.from_numpy(labels),
                       torch.from_numpy(mask), False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ref = params_from_flax(jax.tree.map(np.asarray, grads))
    named = dict(model.named_parameters())
    assert sorted(ref) == sorted(named)
    for key, g in ref.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("name", ["sage", "sage_fused"])
def test_eval_logits_match_flax(data, name, norm, nonlinear):
    _check_eval_logits(data, name, norm, nonlinear)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("name", ["sage", "sage_fused"])
def test_one_step_gradients_match_flax(data, name, norm):
    _check_one_step_gradients(data, name, norm)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("name", ["sage", "sage_fused"])
def test_cbsr_route_eval_logits_match_flax(data, name, norm, cbsr_env):
    _check_eval_logits(data, name, norm, "maxk")


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("name", ["sage", "sage_fused"])
def test_cbsr_route_one_step_gradients_match_flax(data, name, norm,
                                                  cbsr_env):
    _check_one_step_gradients(data, name, norm)


@pytest.mark.parametrize("route", ["mask", "cbsr"])
@pytest.mark.parametrize("name", ["sage", "sage_fused"])
def test_models_take_the_selected_route(data, name, route, monkeypatch):
    if route == "cbsr":
        monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    calls = []
    topk = spgemm_mod.cbsr_topk
    monkeypatch.setattr(spgemm_mod, "cbsr_topk",
                        lambda x, k: calls.append(k) or topk(x, k))
    model = build_model(name, F_IN, HID, LAYERS, CLASSES, maxk=K,
                        compute_dtype="float32")
    graphs = GraphBundle.for_model(data[1], name, device="cpu")
    model(graphs, torch.from_numpy(data[2])).sum().backward()
    assert calls == ([K] * LAYERS if route == "cbsr" else [])


def test_parameter_names_match_flax(data):
    flax_model, _, params, model, _ = _init_pair(data, "sage", True, "maxk")
    assert sorted(params_from_flax(params)) == sorted(model.state_dict())
    assert model.norm_0.eps == 1e-6


def test_unknown_or_missing_params_raise(data):
    _, _, params, model, _ = _init_pair(data, "sage", False, "maxk")
    params = jax.tree.map(np.asarray, params)
    bad_leaf = dict(params, lin_in=dict(params["lin_in"], gamma=np.ones(3)))
    with pytest.raises(ValueError, match="gamma"):
        model.load_flax_params(bad_leaf)
    extra_module = dict(params, lin_extra=params["lin_out"])
    with pytest.raises(RuntimeError, match="lin_extra"):
        model.load_flax_params(extra_module)
    missing = {k: v for k, v in params.items() if k != "fc_neigh_1"}
    with pytest.raises(RuntimeError, match="fc_neigh_1"):
        model.load_flax_params(missing)


def test_init_is_xavier_from_generator():
    a = build_model("sage", 16, 32, 2, 4, generator=torch.Generator()
                    .manual_seed(5))
    b = build_model("sage", 16, 32, 2, 4, generator=torch.Generator()
                    .manual_seed(5))
    for (ka, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), ka
    bound = np.sqrt(6.0 / (32 + 32))
    w = a.fc_self_0.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert torch.count_nonzero(a.lin_in.bias) == 0


def test_dropout_only_in_training(data):
    _, port_csr, x, _, _ = data
    model = build_model("sage", F_IN, HID, LAYERS, CLASSES, maxk=K,
                        feat_drop=0.5, compute_dtype="float32")
    graphs = GraphBundle.for_model(port_csr, "sage", device="cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        e1, e2 = model(graphs, xt), model(graphs, xt)
        gen = torch.Generator().manual_seed(1)
        t1 = model(graphs, xt, training=True, generator=gen)
        t2 = model(graphs, xt, training=True, generator=gen)
    assert torch.equal(e1, e2)
    assert not torch.equal(t1, t2) and not torch.equal(t1, e1)


def test_symmetric_bundle_matches_transpose_built():
    csr = random_graph(120, 5.0, seed=3, weighted=False)
    rows, cols = csr.to_coo()
    sym = CSRGraph.from_coo(np.concatenate([rows, cols]),
                            np.concatenate([cols, rows]).astype(np.int32),
                            csr.n_nodes)
    fast = GraphBundle.from_csr(sym, symmetric=True, device="cpu")
    slow = GraphBundle.from_csr(sym, symmetric=False, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(csr.n_nodes, 8)).astype(np.float32))
    from maxk_tpu_torch.ops.spmm import spmm
    for norm in ("mean", "sum", "sym"):
        a = spmm(getattr(fast, f"g_{norm}_t"), x, "float32")
        b = spmm(getattr(slow, f"g_{norm}_t"), x, "float32")
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
