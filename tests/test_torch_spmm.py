"""K2's plain version, spmm and spmm_t vs maxk_tpu.

float32 compute agrees with the JAX tiled SpMM and with the TPU kernel
in interpret mode at rtol=1e-5, atol=1e-6 (only the summation order
differs). bfloat16 compute (x rounded to bf16, float32 edge values and
accumulation on both sides) stays within the reference's own tolerance,
mean absolute error < 1e-3 (BASELINE.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops.graph import CSRGraph as JaxCSRGraph, build_tiled_graph
from maxk_tpu.ops.pallas_spmm import spmm_pallas
from maxk_tpu.ops.spmm import spmm as jax_spmm, spmm_t as jax_spmm_t
from maxk_tpu_torch.ops import cuda_spmm
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spmm import spmm, spmm_dense_oracle, spmm_t

from conftest import random_graph


def _with_empty_rows(n: int, seed: int) -> JaxCSRGraph:
    """Weighted graph whose rows 3i have no edges (and some columns no
    in-edges), so zero-degree rows are exercised on both sides."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 8 * n)
    src = src[src % 3 != 0]
    dst = rng.integers(0, n // 2, src.shape[0]).astype(np.int32)
    vals = rng.uniform(size=src.shape[0]).astype(np.float32)
    return JaxCSRGraph.from_coo(src, dst, n, vals)


GRAPHS = {
    "uniform": lambda: random_graph(300, 8.0, seed=1),
    "power_law": lambda: random_graph(400, 12.0, seed=2, power_law=True),
    "empty_rows": lambda: _with_empty_rows(300, seed=3),
}


@pytest.fixture(params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


def _dev(g) -> DeviceCSR:
    return DeviceCSR.from_csr(CSRGraph(g.indptr, g.indices, g.values), "cpu")


def _x(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("d", [64, 256])
def test_spmm_f32_matches_jax(graph, d):
    x = _x(graph.n_nodes, d, seed=d)
    ref = np.asarray(jax_spmm(build_tiled_graph(graph), jnp.asarray(x),
                              compute_dtype=jnp.float32))
    out = spmm(_dev(graph), torch.from_numpy(x), "float32")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_spmm_f32_matches_pallas_interpret(graph):
    x = _x(graph.n_nodes, 64, seed=5)
    ref = np.asarray(spmm_pallas(build_tiled_graph(graph), jnp.asarray(x),
                                 compute_dtype=jnp.float32, interpret=True))
    out = spmm(_dev(graph), torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [64, 256])
def test_spmm_bf16_matches_jax(graph, d):
    x = _x(graph.n_nodes, d, seed=d + 1)
    ref = np.asarray(jax_spmm(build_tiled_graph(graph), jnp.asarray(x)))
    out = spmm(_dev(graph), torch.from_numpy(x))      # bf16 by default
    assert out.dtype == torch.float32
    assert np.mean(np.abs(out.numpy() - ref)) < 1e-3
    # Both sides compute the same function; only the order differs.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_spmm_bf16_input_keeps_dtype(graph):
    x = torch.from_numpy(_x(graph.n_nodes, 32)).to(torch.bfloat16)
    out = spmm(_dev(graph), x)
    assert out.dtype == torch.bfloat16
    ref = spmm_csr_plain(_dev(graph), x).to(torch.bfloat16)
    assert torch.equal(out, ref)


def test_spmm_matches_dense_oracle(graph):
    port = CSRGraph(graph.indptr, graph.indices, graph.values)
    x = _x(graph.n_nodes, 48, seed=7)
    out = spmm(_dev(graph), torch.from_numpy(x), "float32").numpy()
    np.testing.assert_allclose(out, spmm_dense_oracle(port, x),
                               rtol=1e-5, atol=1e-5)


def test_zero_degree_rows_are_zero():
    g = _with_empty_rows(300, seed=3)
    out = spmm(_dev(g), torch.from_numpy(_x(300, 16)), "float32").numpy()
    empty = np.diff(g.indptr) == 0
    assert empty.sum() >= 100
    assert np.all(out[empty] == 0.0)


def test_plain_chunking_does_not_change_result(graph, monkeypatch):
    x = torch.from_numpy(_x(graph.n_nodes, 40, seed=9))
    whole = spmm_csr_plain(_dev(graph), x)
    monkeypatch.setattr(cuda_spmm, "_PLAIN_CHUNK_ELEMS", 40 * 37)
    chunked = spmm_csr_plain(_dev(graph), x)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_spmm_t_gradient_matches_jax(graph, compute):
    x = _x(graph.n_nodes, 64, seed=11)
    dy = _x(graph.n_nodes, 64, seed=12)
    cd = jnp.float32 if compute == "float32" else jnp.bfloat16
    g, g_t = build_tiled_graph(graph), build_tiled_graph(graph.transpose())
    y_ref, vjp = jax.vjp(lambda a: jax_spmm_t(g, g_t, a, compute_dtype=cd),
                         jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dy))

    dev, dev_t = _dev(graph), _dev(graph.transpose())
    xt = torch.from_numpy(x).requires_grad_(True)
    y = spmm_t(dev, dev_t, xt, compute)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref),
                               rtol=1e-5, atol=1e-5)


def test_spmm_rejects_bad_input():
    dev = _dev(random_graph(50, 4.0))
    with pytest.raises(ValueError, match="rows"):
        spmm_csr(dev, torch.zeros(49, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        spmm_csr(dev, torch.zeros(50, 8, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmm(dev, torch.zeros(50, 8), "int8")
