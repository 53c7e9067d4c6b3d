"""maxk_spgemm, on its mask and CBSR routes, and the CBSR route's parts
(spgemm_forward_cbsr, sspmm_sampled) vs maxk_tpu.

At compute_dtype=float32 the forward and dx agree at rtol=1e-5 (the
masks are identical; only the SpMM's summation order differs). At the
default bfloat16 compute both sides round the same operands, so they
agree well inside the reference tolerance (mean error < 1e-3). There the
JAX package's CBSR route returns a bfloat16 dx for a float32 x and the
port a float32 one holding the same bf16-rounded values: the comparison
is in float32.

``test_maxk_spgemm_split_rows_f32_matches_jax`` runs the mask route at
segment length 4, where K2 sums most rows from partials.

MAXK_FUSED_MASK=0 selects the CBSR route in both packages. The JAX
package reads it while tracing, so the ``cbsr_env`` fixture sets it
before any JAX function is built.

Each JAX reference of ``maxk_spgemm`` runs as one jitted program (forward
and vjp together), built once per (route, k, compute dtype) and cached at
module scope; jit keys its compiled code on the graph's shapes and on D.
Run eagerly, the reference went op by op and compiled its pieces anew in
every test. The route is part of the key, read from the environment when
the reference is called, and JAX's caches are cleared whenever it
differs from the last reference's (and when the module ends), so no
trace made on one route serves the other.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
import maxk_tpu
from maxk_tpu.ops import spgemm as jax_spgemm
from maxk_tpu.ops.graph import build_tiled_graph
from maxk_tpu_torch.ops.cbsr import cbsr_expand_int8, cbsr_topk
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_plain
from maxk_tpu_torch.ops.graph import SEG_LEN, CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import (maxk_spgemm, spgemm_forward_cbsr,
                                       sspmm_sampled)

from conftest import random_graph


@pytest.fixture(params=["uniform", "power_law"])
def graph(request):
    g = random_graph(300, 10.0, seed=21,
                     power_law=request.param == "power_law")
    return g.normalize("mean")


@pytest.fixture
def cbsr_env(monkeypatch):
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_after_module():
    yield
    jax.clear_caches()


def _port_graphs(graph, seg_len=SEG_LEN):
    t = graph.transpose()
    return (DeviceCSR.from_csr(
        CSRGraph(graph.indptr, graph.indices, graph.values), "cpu",
        seg_len=seg_len),
        DeviceCSR.from_csr(CSRGraph(t.indptr, t.indices, t.values), "cpu",
                           seg_len=seg_len))


def _run_port(graph, x, dy, k, compute_dtype, seg_len=SEG_LEN):
    dev, dev_t = _port_graphs(graph, seg_len)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxk_spgemm(dev, dev_t, xt, k, compute_dtype)
    y.backward(torch.from_numpy(dy))
    assert y.dtype == xt.grad.dtype == torch.float32
    return y.detach().numpy(), xt.grad.numpy()


@functools.cache
def _jax_maxk_spgemm(route, k, compute_dtype):
    """jit of (g, g_t, x, dy) -> (maxk_tpu.maxk_spgemm(g, g_t, x), dx) on
    `route`, which must be the environment's when it is called."""
    cd = None if compute_dtype is None else jnp.dtype(compute_dtype)

    def fwd_vjp(g, g_t, x, dy):
        y, vjp = jax.vjp(
            lambda a: maxk_tpu.maxk_spgemm(g, g_t, a, k, compute_dtype=cd),
            x)
        return y, vjp(dy)[0]
    return jax.jit(fwd_vjp)


_LAST_ROUTE = [None]


def _route():
    """The environment's route; clears JAX's caches when it changed."""
    route = "cbsr" if os.environ.get("MAXK_FUSED_MASK") == "0" else "mask"
    if route != _LAST_ROUTE[0]:
        jax.clear_caches()
        _LAST_ROUTE[0] = route
    return route


def _run_both(graph, k, d, compute_dtype, seg_len=SEG_LEN):
    rng = np.random.default_rng(k * d)
    x = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    dy = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    g, g_t = build_tiled_graph(graph), build_tiled_graph(graph.transpose())
    y_ref, dx_ref = _jax_maxk_spgemm(_route(), k, compute_dtype)(
        g, g_t, jnp.asarray(x), jnp.asarray(dy))
    y, dx = _run_port(graph, x, dy, k, compute_dtype, seg_len)
    return y, np.asarray(y_ref), dx, np.asarray(dx_ref, np.float32)


@pytest.mark.parametrize("k,d", [(8, 64), (32, 64), (32, 256)])
def test_maxk_spgemm_f32_matches_jax(graph, k, d):
    y, y_ref, dx, dx_ref = _run_both(graph, k, d, "float32")
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-5, atol=1e-6)
    # dx is zero exactly off the top-k support.
    assert np.count_nonzero(dx, axis=1).max() <= k


def test_maxk_spgemm_split_rows_f32_matches_jax(graph):
    """seg_len 4: most rows of A and A^T are summed from partials."""
    y, y_ref, dx, dx_ref = _run_both(graph, 8, 64, "float32", seg_len=4)
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(dx, axis=1).max() <= 8


def test_maxk_spgemm_default_bf16_matches_jax(graph):
    y, y_ref, dx, dx_ref = _run_both(graph, 16, 128, None)
    assert np.mean(np.abs(y - y_ref)) < 1e-3
    assert np.mean(np.abs(dx - dx_ref)) < 1e-3


@pytest.mark.parametrize("k,d", [(8, 64), (32, 64), (32, 256)])
def test_maxk_spgemm_cbsr_f32_matches_jax(graph, k, d, cbsr_env):
    y, y_ref, dx, dx_ref = _run_both(graph, k, d, "float32")
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(dx, axis=1).max() <= k


def test_maxk_spgemm_cbsr_default_bf16_matches_jax(graph, cbsr_env):
    y, y_ref, dx, dx_ref = _run_both(graph, 16, 128, None)
    assert np.mean(np.abs(y - y_ref)) < 1e-3
    assert np.mean(np.abs(dx - dx_ref)) < 1e-3


@pytest.mark.parametrize("compute_dtype", ["float32", None])
def test_cbsr_and_mask_routes_agree(graph, compute_dtype, monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(graph.n_nodes, 64)).astype(np.float32)
    dy = rng.normal(size=(graph.n_nodes, 64)).astype(np.float32)
    y_mask, dx_mask = _run_port(graph, x, dy, 16, compute_dtype)
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    y, dx = _run_port(graph, x, dy, 16, compute_dtype)
    # Both routes hand K2 the same operand, so the forward is exact; the
    # CBSR backward rounds A^T @ dy to bfloat16 under bfloat16 compute.
    np.testing.assert_array_equal(y, y_mask)
    if compute_dtype is None:
        dx_mask = torch.from_numpy(dx_mask).to(torch.bfloat16).float()
    np.testing.assert_array_equal(dx, np.asarray(dx_mask))


_JIT_FORWARD_CBSR = jax.jit(jax_spgemm.spgemm_forward_cbsr,
                            static_argnames=("dim", "compute_dtype"))
_JIT_SSPMM_SAMPLED = jax.jit(jax_spgemm.sspmm_sampled,
                             static_argnames=("compute_dtype",))


@pytest.mark.parametrize("compute_dtype", ["float32", None])
def test_spgemm_forward_cbsr_matches_jax(graph, compute_dtype):
    d, k = 96, 12
    x = np.random.default_rng(9).normal(
        size=(graph.n_nodes, d)).astype(np.float32)
    v, s = maxk_tpu.cbsr_topk(jnp.asarray(x), k)
    cd = None if compute_dtype is None else jnp.dtype(compute_dtype)
    ref = np.asarray(_JIT_FORWARD_CBSR(build_tiled_graph(graph), v, s, d,
                                       compute_dtype=cd))
    out = spgemm_forward_cbsr(
        _port_graphs(graph)[0], torch.from_numpy(np.array(v)),
        torch.from_numpy(np.array(s)), d, compute_dtype).numpy()
    if compute_dtype is None:
        assert np.mean(np.abs(out - ref)) < 1e-3
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", None])
def test_sspmm_sampled_matches_jax(graph, compute_dtype):
    d, k = 96, 12
    rng = np.random.default_rng(8)
    dy = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    _, s = maxk_tpu.cbsr_topk(jnp.asarray(
        rng.normal(size=(graph.n_nodes, d)).astype(np.float32)), k)
    cd = None if compute_dtype is None else jnp.dtype(compute_dtype)
    ref = _JIT_SSPMM_SAMPLED(build_tiled_graph(graph.transpose()),
                             jnp.asarray(dy), s, compute_dtype=cd)
    out = sspmm_sampled(_port_graphs(graph)[1], torch.from_numpy(dy),
                        torch.from_numpy(np.array(s)), compute_dtype)
    # Both hand the sampler bfloat16 under bfloat16 compute.
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    if compute_dtype is None:
        assert np.mean(np.abs(out - ref)) < 1e-3
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [64, 62])
def test_int8_rowscale_forward_is_the_row_scaled_table(d):
    """"int8_rowscale" at D % 4 == 0 is K7 (its plain version) on K6's
    int8 table; at other D it computes in bfloat16, as in the JAX
    package."""
    graph = random_graph(100, 5.0, seed=21, power_law=True).normalize("mean")
    dev = _port_graphs(graph)[0]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(graph.n_nodes, d)).astype(np.float32))
    v, s = cbsr_topk(x, 8)
    out = spgemm_forward_cbsr(dev, v, s, d, "int8_rowscale")
    if d % 4 == 0:
        want = spmm_int8_plain(dev, *cbsr_expand_int8(v, s, d), True)
    else:
        want = spgemm_forward_cbsr(dev, v, s, d, "bfloat16")
    assert torch.equal(out, want)
