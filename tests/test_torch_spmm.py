"""K2's plain version, spmm and spmm_t vs maxk_tpu.

float32 compute agrees with the JAX tiled SpMM and with the TPU kernel
in interpret mode at rtol=1e-5, atol=1e-6 (only the summation order
differs). bfloat16 compute (x rounded to bf16, float32 edge values and
accumulation on both sides) stays within the reference's own tolerance,
mean absolute error < 1e-3 (BASELINE.md).

The parity tests run at the default segment length and, as the
``*_split_rows`` cases, at seg_len 2 and 8, where most rows of these
graphs are split and summed from partials. Each JAX reference is computed
once per graph and reused across segment lengths.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.ops.graph import CSRGraph as JaxCSRGraph, build_tiled_graph
from maxk_tpu.ops.pallas_spmm import spmm_pallas
from maxk_tpu.ops.spmm import spmm as jax_spmm, spmm_t as jax_spmm_t
from maxk_tpu_torch.ops import cuda_spmm
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
from maxk_tpu_torch.ops.graph import SEG_LEN, CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_plain
from maxk_tpu_torch.ops.spmm import (quantize_columns, spmm,
                                     spmm_dense_oracle, spmm_t)

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


# Segment lengths of the *_split_rows cases.
SPLIT_SEG_LENS = [2, 8]


@functools.cache
def _graph(name: str) -> JaxCSRGraph:
    return GRAPHS[name]()


@pytest.fixture(params=sorted(GRAPHS))
def graph_name(request):
    return request.param


@pytest.fixture
def graph(graph_name):
    return _graph(graph_name)


def _dev(g, seg_len: int = SEG_LEN) -> DeviceCSR:
    return _dev_cached(id(g), g, seg_len)


_DEVS = {}


def _dev_cached(key, g, seg_len: int) -> DeviceCSR:
    """One DeviceCSR (and segment plan) per graph and segment length:
    the cases of a graph share it (no op changes one). The graph is kept
    beside it, so its id is not reused."""
    if (key, seg_len) not in _DEVS:
        _DEVS[key, seg_len] = (g, DeviceCSR.from_csr(
            CSRGraph(g.indptr, g.indices, g.values), "cpu", seg_len=seg_len))
    return _DEVS[key, seg_len][1]


def _x(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@functools.cache
def _jax_spmm_ref(name: str, d: int, seed: int, f32: bool) -> np.ndarray:
    g = _graph(name)
    kw = {"compute_dtype": jnp.float32} if f32 else {}
    return np.asarray(jax_spmm(build_tiled_graph(g),
                               jnp.asarray(_x(g.n_nodes, d, seed)), **kw))


def _check_spmm_f32(name, d, seg_len):
    g = _graph(name)
    ref = _jax_spmm_ref(name, d, d, True)
    out = spmm(_dev(g, seg_len), torch.from_numpy(_x(g.n_nodes, d, seed=d)),
               "float32")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [64, 256])
def test_spmm_f32_matches_jax(graph_name, d):
    _check_spmm_f32(graph_name, d, SEG_LEN)


@pytest.mark.parametrize("seg_len", SPLIT_SEG_LENS)
@pytest.mark.parametrize("d", [64, 256])
def test_spmm_f32_split_rows_matches_jax(graph_name, d, seg_len):
    _check_spmm_f32(graph_name, d, seg_len)


def test_spmm_f32_matches_pallas_interpret(graph):
    x = _x(graph.n_nodes, 64, seed=5)
    ref = np.asarray(spmm_pallas(build_tiled_graph(graph), jnp.asarray(x),
                                 compute_dtype=jnp.float32, interpret=True))
    out = spmm(_dev(graph), torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def _check_spmm_bf16(name, d, seg_len):
    g = _graph(name)
    ref = _jax_spmm_ref(name, d, d + 1, False)
    out = spmm(_dev(g, seg_len),                    # bf16 by default
               torch.from_numpy(_x(g.n_nodes, d, seed=d + 1)))
    assert out.dtype == torch.float32
    assert np.mean(np.abs(out.numpy() - ref)) < 1e-3
    # Both sides compute the same function; only the order differs.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [64, 256])
def test_spmm_bf16_matches_jax(graph_name, d):
    _check_spmm_bf16(graph_name, d, SEG_LEN)


@pytest.mark.parametrize("seg_len", SPLIT_SEG_LENS)
@pytest.mark.parametrize("d", [64, 256])
def test_spmm_bf16_split_rows_matches_jax(graph_name, d, seg_len):
    _check_spmm_bf16(graph_name, d, seg_len)


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


@functools.cache
def _jax_spmm_t_ref(name: str, compute: str):
    graph = _graph(name)
    cd = jnp.float32 if compute == "float32" else jnp.bfloat16
    g, g_t = build_tiled_graph(graph), build_tiled_graph(graph.transpose())
    y_ref, vjp = jax.vjp(lambda a: jax_spmm_t(g, g_t, a, compute_dtype=cd),
                         jnp.asarray(_x(graph.n_nodes, 64, seed=11)))
    (dx_ref,) = vjp(jnp.asarray(_x(graph.n_nodes, 64, seed=12)))
    return np.asarray(y_ref), np.asarray(dx_ref)


def _reorder_bound(g, x: np.ndarray) -> np.ndarray:
    """2 * n_r * 2**-24 * sum_e |v_e| |x[c_e]|: how far two float32 sums
    of row r's n_r terms may lie apart, whatever their orders."""
    a = CSRGraph(g.indptr, g.indices, np.abs(g.values))
    n = np.diff(g.indptr)[:, None].astype(np.float64)
    return 2 * n * 2.0 ** -24 * spmm_dense_oracle(a, np.abs(x))


def _check_spmm_t(name, compute, seg_len, reorder=False):
    """rtol=atol=1e-5 against JAX; with `reorder`, plus the two-order
    bound per element: the transposed power-law graph has a row of 779
    terms, on which the JAX result itself lies 2.6e-5 from the float64
    sum, so a split order may part from it by more than 1e-5. The split
    cases are then also held to the float64 sum at rtol=atol=1e-5."""
    graph = _graph(name)
    y_ref, dx_ref = _jax_spmm_t_ref(name, compute)
    dev = _dev(graph, seg_len)
    dev_t = _dev(graph.transpose(), seg_len)
    x = _x(graph.n_nodes, 64, seed=11)
    dy = _x(graph.n_nodes, 64, seed=12)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = spmm_t(dev, dev_t, xt, compute)
    y.backward(torch.from_numpy(dy))
    for out, ref, g, v in ((y.detach().numpy(), y_ref, graph, x),
                           (xt.grad.numpy(), dx_ref, graph.transpose(), dy)):
        tol = 1e-5 + 1e-5 * np.abs(ref)
        if reorder:
            tol = tol + _reorder_bound(g, v)
            if compute == "bfloat16":
                v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
            exact = spmm_dense_oracle(g, v)
            np.testing.assert_allclose(out, exact, rtol=1e-5, atol=1e-5)
        assert (np.abs(out - ref) <= tol).all()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_spmm_t_gradient_matches_jax(graph_name, compute):
    _check_spmm_t(graph_name, compute, SEG_LEN)


@pytest.mark.parametrize("seg_len", SPLIT_SEG_LENS)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_spmm_t_gradient_split_rows_matches_jax(graph_name, compute,
                                                seg_len):
    _check_spmm_t(graph_name, compute, seg_len, reorder=True)


def test_spmm_rejects_bad_input():
    dev = _dev(random_graph(50, 4.0))
    with pytest.raises(ValueError, match="rows"):
        spmm_csr(dev, torch.zeros(49, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        spmm_csr(dev, torch.zeros(50, 8, dtype=torch.float64))
    with pytest.raises(TypeError, match="int8_rowscale"):
        spmm(dev, torch.zeros(50, 8), "int8_rowscale")
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        spmm(dev, torch.zeros(50, 8), "float16")


def test_spmm_int8_is_k7_on_quantized_columns():
    """"int8" is K7 (its plain version) on the per-column int8 table."""
    graph = _graph("empty_rows")
    dev = _dev(graph)
    x = torch.from_numpy(_x(graph.n_nodes, 64))
    want = spmm_int8_plain(dev, *quantize_columns(x), row_scale=False)
    assert torch.equal(spmm(dev, x, "int8"), want)
    assert torch.equal(spmm(dev, x, torch.int8), want)


def test_spmm_refuses_graph_without_plan():
    dev = dataclasses.replace(_dev(random_graph(50, 4.0)), plan=None)
    for fn in (spmm_csr, spmm_csr_plain):
        with pytest.raises(ValueError, match="from_csr"):
            fn(dev, torch.zeros(50, 8))


def test_split_rows_sum_partials_in_segment_order():
    """A row of 9 edges at seg_len 2 is five partials; the plain version
    sums them from 0.0 in segment order, so it equals that loop bit for
    bit."""
    csr = CSRGraph(np.array([0, 9, 9], np.int64), np.zeros(9, np.int32),
                   np.linspace(0.1, 0.9, 9).astype(np.float32))
    x = torch.tensor([[1e8, 1.0], [3.0, 0.5]], dtype=torch.float32)
    out = spmm_csr_plain(DeviceCSR.from_csr(csr, "cpu", seg_len=2), x)
    expect = torch.zeros(2)
    for lo in range(0, 9, 2):
        part = torch.zeros(2)
        for e in range(lo, min(lo + 2, 9)):
            part += torch.tensor(csr.values[e]) * x[0]
        expect += part
    assert torch.equal(out[0], expect)
    assert torch.equal(out[1], torch.zeros(2))


@pytest.mark.parametrize("seg_len", [SEG_LEN, 2])
def test_rectangular_graph_matches_dense_oracle(seg_len):
    """A row shard's graph: 60 rows whose columns index a 150-row table
    (n_cols > n_nodes), some rows empty. K2's plain version gives
    (60, D) rows equal to the dense oracle's, and an x of the wrong
    row count is refused."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 60, 700)
    src = src[src % 7 != 0]
    dst = rng.integers(0, 150, src.shape[0]).astype(np.int32)
    vals = rng.uniform(size=src.shape[0]).astype(np.float32)
    csr = CSRGraph.from_coo(src, dst, 60, vals)
    g = DeviceCSR.from_csr(csr, "cpu", seg_len=seg_len, n_cols=150)
    assert (g.n_nodes, g.n_cols) == (60, 150)
    x = rng.normal(size=(150, 24)).astype(np.float32)
    dense = np.zeros((60, 150))
    np.add.at(dense, (src[np.argsort(src, kind="stable")],
                      csr.indices), csr.values.astype(np.float64))
    out = spmm_csr(g, torch.from_numpy(x))
    assert out.shape == (60, 24)
    np.testing.assert_allclose(out.numpy(), dense @ x, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(spmm(g, torch.from_numpy(x), "float32"), out)
    with pytest.raises(ValueError, match="150 columns"):
        spmm_csr(g, torch.zeros(60, 24))
