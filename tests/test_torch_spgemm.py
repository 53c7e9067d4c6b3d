"""maxk_spgemm (mask route) vs maxk_tpu.maxk_spgemm.

At compute_dtype=float32 the forward and dx agree at rtol=1e-5 (the
masks are identical; only the SpMM's summation order differs). At the
default bfloat16 compute both sides round the same operands, so they
agree well inside the reference tolerance (mean error < 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maxk_tpu
from maxk_tpu.ops.graph import build_tiled_graph
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm

from conftest import random_graph


@pytest.fixture(params=["uniform", "power_law"])
def graph(request):
    g = random_graph(300, 10.0, seed=21,
                     power_law=request.param == "power_law")
    return g.normalize("mean")


def _run_both(graph, k, d, compute_dtype):
    rng = np.random.default_rng(k * d)
    x = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    dy = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    g, g_t = build_tiled_graph(graph), build_tiled_graph(graph.transpose())
    cd = None if compute_dtype is None else jnp.dtype(compute_dtype)
    y_ref, vjp = jax.vjp(
        lambda a: maxk_tpu.maxk_spgemm(g, g_t, a, k, compute_dtype=cd),
        jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dy))

    dev = DeviceCSR.from_csr(
        CSRGraph(graph.indptr, graph.indices, graph.values), "cpu")
    t = graph.transpose()
    dev_t = DeviceCSR.from_csr(CSRGraph(t.indptr, t.indices, t.values),
                               "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxk_spgemm(dev, dev_t, xt, k, compute_dtype)
    y.backward(torch.from_numpy(dy))
    return (y.detach().numpy(), np.asarray(y_ref), xt.grad.numpy(),
            np.asarray(dx_ref))


@pytest.mark.parametrize("k,d", [(8, 64), (32, 64), (32, 256)])
def test_maxk_spgemm_f32_matches_jax(graph, k, d):
    y, y_ref, dx, dx_ref = _run_both(graph, k, d, "float32")
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-5, atol=1e-6)
    # dx is zero exactly off the top-k support.
    assert np.count_nonzero(dx, axis=1).max() <= k


def test_maxk_spgemm_default_bf16_matches_jax(graph):
    y, y_ref, dx, dx_ref = _run_both(graph, 16, 128, None)
    assert np.mean(np.abs(y - y_ref)) < 1e-3
    assert np.mean(np.abs(dx - dx_ref)) < 1e-3


def test_cbsr_route_not_ported(monkeypatch):
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    dev = DeviceCSR.from_csr(CSRGraph.from_coo([0, 1], [1, 0], 2), "cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        maxk_spgemm(dev, dev, torch.zeros(2, 4), 2)
