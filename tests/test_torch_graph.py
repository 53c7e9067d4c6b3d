"""maxk_tpu_torch graph containers and data generators vs maxk_tpu.

Every comparison is bit-equal: the port's numpy code must reproduce the
JAX package's CSR arrays and seeded datasets exactly.
"""

import dataclasses

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from maxk_tpu.data import datasets as jax_datasets
from maxk_tpu.data import loaders as jax_loaders
from maxk_tpu.ops.graph import CSRGraph as JaxCSRGraph
from maxk_tpu_torch.data import datasets, loaders
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, resolve_device

from conftest import random_graph


def _port(g) -> CSRGraph:
    return CSRGraph(g.indptr, g.indices, g.values)


def _assert_bits(a, b):
    """Same dtype, shape and bits (float compared as raw bits)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        a, b = a.view(np.uint8), b.view(np.uint8)
    np.testing.assert_array_equal(a, b)


def _assert_same_csr(port, ref):
    _assert_bits(port.indptr, ref.indptr)
    _assert_bits(port.indices, ref.indices)
    _assert_bits(port.values, ref.values)


@pytest.fixture(params=["uniform", "power_law"])
def graph(request):
    return random_graph(300, 9.0, seed=4,
                        power_law=request.param == "power_law")


def test_from_coo_bit_equal(graph):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 300, 4000)
    dst = rng.integers(0, 300, 4000).astype(np.int32)
    vals = rng.uniform(size=4000).astype(np.float32)
    _assert_same_csr(CSRGraph.from_coo(src, dst, 300, vals),
                     JaxCSRGraph.from_coo(src, dst, 300, vals))
    rows, cols = graph.to_coo()
    port_rows, port_cols = _port(graph).to_coo()
    _assert_bits(port_rows, rows)
    _assert_bits(port_cols, cols)


@pytest.mark.parametrize("mode", ["none", "mean", "sym"])
def test_normalize_bit_equal(graph, mode):
    _assert_same_csr(_port(graph).normalize(mode), graph.normalize(mode))


def test_transpose_bit_equal(graph):
    _assert_same_csr(_port(graph).transpose(), graph.transpose())
    _assert_same_csr(_port(graph).normalize("mean").transpose(),
                     graph.normalize("mean").transpose())


def test_self_loops_bit_equal(graph):
    looped = graph.add_self_loops()
    _assert_same_csr(_port(graph).add_self_loops(), looped)
    _assert_same_csr(_port(looped).remove_self_loops(),
                     looped.remove_self_loops())
    _assert_same_csr(_port(graph).add_self_loops(dedup=False),
                     graph.add_self_loops(dedup=False))


def test_degrees_and_with_values(graph):
    port = _port(graph)
    _assert_bits(port.in_degrees, graph.in_degrees)
    _assert_bits(port.out_degrees, graph.out_degrees)
    vals = np.arange(graph.n_edges, dtype=np.float32)
    _assert_same_csr(port.with_values(vals), graph.with_values(vals))


@pytest.mark.parametrize("kw", [
    dict(n_nodes=500, avg_degree=7.0, seed=3),
    dict(n_nodes=400, avg_degree=5.0, seed=8, power_law=False),
    dict(n_nodes=300, avg_degree=6.0, seed=9, self_loops=True,
         symmetric=False),
])
def test_synthetic_graph_bit_equal(kw):
    _assert_same_csr(loaders.synthetic_graph(**kw),
                     jax_loaders.synthetic_graph(**kw))


def test_rmat_graph_bit_equal():
    _assert_same_csr(loaders.rmat_graph(512, 6.0, seed=5),
                     jax_loaders.rmat_graph(512, 6.0, seed=5))


def _assert_same_dataset(port, ref):
    _assert_same_csr(port.csr, ref.csr)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        _assert_bits(getattr(port, f), getattr(ref, f))
    for f in ("name", "num_classes", "multilabel", "metric", "symmetric"):
        assert getattr(port, f) == getattr(ref, f)


def test_make_synthetic_dataset_bit_equal():
    kw = dict(n_nodes=512, avg_degree=16.0, n_classes=12, in_size=64,
              seed=97, feature_noise=4.0, rewire_p=0.7, train_frac=0.05)
    _assert_same_dataset(datasets.make_synthetic_dataset(**kw),
                         jax_datasets.make_synthetic_dataset(**kw))
    _assert_same_dataset(datasets.load_dataset("synthetic", seed=3),
                         jax_datasets.load_dataset("synthetic", seed=3))


def test_make_synthetic_multilabel_dataset_bit_equal():
    kw = dict(n_nodes=400, avg_degree=8.0, seed=2)
    _assert_same_dataset(
        datasets.make_synthetic_multilabel_dataset(**kw),
        jax_datasets.make_synthetic_multilabel_dataset(**kw))


def test_csr_binary_roundtrip(tmp_path):
    g = _port(random_graph(200, 5.0, seed=6))
    loaders.save_csr_binary(g, tmp_path, "g")
    back = loaders.load_csr_binary(tmp_path, "g.indptr")
    _assert_bits(back.indptr, g.indptr)
    _assert_bits(back.indices, g.indices)
    assert loaders.available_graphs(tmp_path) == ["g"]
    ref = jax_loaders.load_csr_binary(tmp_path, "g")
    _assert_bits(back.indptr, ref.indptr)


def test_device_csr_from_csr(graph):
    port = _port(graph).normalize("mean")
    dev = DeviceCSR.from_csr(port, "cpu")
    assert dev.indptr.dtype == torch.int64
    assert dev.indices.dtype == torch.int32
    assert dev.values.dtype == torch.float32
    assert dev.n_nodes == graph.n_nodes and dev.n_edges == graph.n_edges
    _assert_bits(dev.values.numpy(), port.values)


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceCSR.from_csr(_port(random_graph(20, 3.0)))
    assert resolve_device("cpu") == torch.device("cpu")


def test_dataset_dataclass_fields_match():
    names = [f.name for f in dataclasses.fields(datasets.Dataset)]
    assert names == [f.name for f in dataclasses.fields(
        jax_datasets.Dataset)]
