"""The CBSR-operand forward (CBSR_GATHER_MODE, K5) vs maxk_tpu.

Under ``CBSR_GATHER_MODE = True`` both packages take the CBSR route of
``maxk_spgemm`` and, within the gate (dim <= 256, k <= 128), read the
CBSR rows per edge in the forward. The JAX package runs its XLA scan
(``_spgemm_cbsr_impl``) on the CPU; the port runs K5's plain version,
``spgemm_cbsr_plain``. They agree at float32 compute at rtol 1e-5, atol
1e-6 (other summation orders), and at bfloat16 compute (both round the
values to bfloat16) within the reference tolerance, mean error < 1e-3.

Outside the gate both run the expansion, and the port never calls K5's
wrapper (a spy); with the flag off nothing calls it. The plain version
is held to K2's on the expansion at rtol 1e-6: it fuses each product
into its sum (``fma_f32``, which K5 and K2 use on the card) where K2's
plain version rounds the product first.

The JAX package reads its flag while tracing. The ``gather_mode``
fixture sets it (and the port's) before any JAX function is built, and
JAX's caches are cleared whenever the flag differs from the last
reference's and when the module ends, so no trace made with the flag
off serves a test here, and none made here serves another file.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
import maxk_tpu
from maxk_tpu.ops import spgemm as jax_spgemm
from maxk_tpu.ops.graph import build_tiled_graph
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.ops import spgemm as port_spgemm
from maxk_tpu_torch.ops.cbsr import cbsr_expand
from maxk_tpu_torch.ops.cuda_spgemm_cbsr import (fma_f32, spgemm_cbsr_csr,
                                                 spgemm_cbsr_plain)
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr_plain
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spgemm_forward_cbsr
from maxk_tpu_torch.train.loop import Trainer

from conftest import random_graph


@pytest.fixture(scope="module", params=["uniform", "power_law"])
def graph(request):
    g = random_graph(300, 10.0, seed=21,
                     power_law=request.param == "power_law")
    return g.normalize("mean")


_LAST_FLAG = [None]


def _sync_jax():
    """Clear JAX's caches when its flag differs from the last trace's."""
    flag = jax_spgemm.CBSR_GATHER_MODE
    if flag != _LAST_FLAG[0]:
        jax.clear_caches()
        _LAST_FLAG[0] = flag


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_after_module():
    yield
    jax.clear_caches()
    _LAST_FLAG[0] = None


@pytest.fixture
def gather_mode(monkeypatch):
    monkeypatch.setattr(jax_spgemm, "CBSR_GATHER_MODE", True)
    monkeypatch.setattr(port_spgemm, "CBSR_GATHER_MODE", True)
    _sync_jax()


@pytest.fixture
def k5_calls(monkeypatch):
    """The calls that reach K5's wrapper from ops/spgemm.py."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return spgemm_cbsr_csr(*args, **kwargs)
    monkeypatch.setattr(port_spgemm, "spgemm_cbsr_csr", spy)
    return calls


def _port(csr, seg_len=None):
    kw = {} if seg_len is None else {"seg_len": seg_len}
    return DeviceCSR.from_csr(
        CSRGraph(csr.indptr, csr.indices, csr.values), "cpu", **kw)


@functools.cache
def _jax_forward_cbsr(flag, dim, compute_dtype):
    del flag                     # part of the key only
    cd = None if compute_dtype is None else jnp.dtype(compute_dtype)
    return jax.jit(lambda g, v, s: jax_spgemm.spgemm_forward_cbsr(
        g, v, s, dim, compute_dtype=cd))


@functools.cache
def _jax_maxk_spgemm(flag, k, compute_dtype):
    del flag
    cd = None if compute_dtype is None else jnp.dtype(compute_dtype)

    def fwd_vjp(g, g_t, x, dy):
        y, vjp = jax.vjp(
            lambda a: maxk_tpu.maxk_spgemm(g, g_t, a, k, compute_dtype=cd),
            x)
        return y, vjp(dy)[0]
    return jax.jit(fwd_vjp)


def _cbsr(graph, k, d, seed):
    """x (V, d) from a seed and its top-k as CBSR, from the JAX package."""
    x = np.random.default_rng(seed).normal(
        size=(graph.n_nodes, d)).astype(np.float32)
    v, s = maxk_tpu.cbsr_topk(jnp.asarray(x), k)
    return x, np.array(v), np.array(s)


def _forward_both(graph, k, d, compute_dtype):
    _, v, s = _cbsr(graph, k, d, seed=k * d)
    _sync_jax()
    ref = np.asarray(_jax_forward_cbsr(
        jax_spgemm.CBSR_GATHER_MODE, d, compute_dtype)(
        build_tiled_graph(graph), jnp.asarray(v), jnp.asarray(s)))
    out = spgemm_forward_cbsr(_port(graph), torch.from_numpy(v),
                              torch.from_numpy(s), d, compute_dtype)
    return out.numpy(), ref


def _assert_close(out, ref, compute_dtype):
    if compute_dtype is None:
        assert np.mean(np.abs(out - ref)) < 1e-3
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", None])
@pytest.mark.parametrize("k,d", [(1, 64), (7, 64), (32, 256), (128, 256)])
def test_forward_cbsr_matches_jax(graph, gather_mode, k5_calls, k, d,
                                  compute_dtype):
    out, ref = _forward_both(graph, k, d, compute_dtype)
    assert k5_calls == [(graph.n_nodes, k)]
    _assert_close(out, ref, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", None])
def test_maxk_spgemm_matches_jax(graph, gather_mode, k5_calls,
                                 compute_dtype):
    k, d = 16, 64
    rng = np.random.default_rng(3)
    x = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    dy = rng.normal(size=(graph.n_nodes, d)).astype(np.float32)
    y_ref, dx_ref = _jax_maxk_spgemm(True, k, compute_dtype)(
        build_tiled_graph(graph), build_tiled_graph(graph.transpose()),
        jnp.asarray(x), jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxk_spgemm(_port(graph), _port(graph.transpose()), xt, k,
                    compute_dtype)
    y.backward(torch.from_numpy(dy))
    assert len(k5_calls) == 1
    _assert_close(y.detach().numpy(), np.asarray(y_ref), compute_dtype)
    _assert_close(xt.grad.numpy(), np.asarray(dx_ref, np.float32),
                  compute_dtype)
    assert np.count_nonzero(xt.grad.numpy(), axis=1).max() <= k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(7, 64), (32, 256)])
def test_plain_matches_k2_plain_on_expansion(graph, k, d, dtype):
    """At segment length 4, where most rows are summed from partials,
    with every 7th row emptied."""
    _, v, s = _cbsr(graph, k, d, seed=k + d)
    rows, cols = graph.to_coo()
    keep = rows % 7 != 0
    g = DeviceCSR.from_csr(CSRGraph.from_coo(
        rows[keep], cols[keep].astype(np.int32), graph.n_nodes,
        graph.values[keep]), "cpu", seg_len=4)
    assert g.plan.n_partials > 0
    values = torch.from_numpy(v).to(dtype)
    selector = torch.from_numpy(s)
    out = spgemm_cbsr_plain(g, values, selector.to(torch.uint8), d)
    ref = spmm_csr_plain(g, cbsr_expand(values, selector, d))
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-7)
    empty = torch.diff(g.indptr) == 0
    assert bool(empty.any()) and bool((out[empty] == 0).all())


def test_fma_f32_rounds_once():
    """a * b + c exactly is 2**-70 off a float32 midpoint (a * b = 2**-24 -
    2**-70): fma_f32 rounds it once, to the nearer neighbour, where a
    float64 product and sum round it onto the midpoint first and then to
    the even neighbour (cases 0 and 2)."""
    up = 1 + 2.0 ** -23
    ab = (1 - 2.0 ** -23) * 2.0 ** -24
    a = np.full(3, up, np.float32)
    b = np.array([ab, -ab, ab], np.float32)
    c = np.array([up, 1 + 2.0 ** -22, -up], np.float32)
    want = np.array([up, 1 + 2.0 ** -22, -up], np.float32)
    ta, tb, tc = (torch.from_numpy(t) for t in (a, b, c))
    got = fma_f32(ta, tb, tc).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    naive = (ta.double() * tb.double() + tc.double()).float().numpy()
    assert (naive != want).tolist() == [True, False, True]


@pytest.mark.parametrize("k,d", [(32, 257), (129, 256)])
def test_outside_the_gate_runs_the_expansion(graph, gather_mode, k5_calls,
                                             k, d):
    out, ref = _forward_both(graph, k, d, "float32")
    assert k5_calls == []
    _assert_close(out, ref, "float32")


def test_flag_off_never_calls_k5(graph, k5_calls, monkeypatch):
    assert port_spgemm.CBSR_GATHER_MODE is False
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(graph.n_nodes, 64)).astype(np.float32))
    g, g_t = _port(graph), _port(graph.transpose())
    for route in ("1", "0"):
        monkeypatch.setenv("MAXK_FUSED_MASK", route)
        assert port_spgemm.uses_cbsr(g) == (route == "0")
        maxk_spgemm(g, g_t, x.clone().requires_grad_(True), 8).sum(
        ).backward()
    spgemm_forward_cbsr(g, *port_spgemm.cbsr_topk(x, 8), 64)
    assert k5_calls == []


def test_flag_takes_cbsr_route_at_any_width(graph, k5_calls, monkeypatch):
    """D = 257, outside K5's gate: the flag still selects the CBSR route,
    as JAX's _mask_path does; under bfloat16 compute its dx is rounded to
    bfloat16, which tells it from the mask route's."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(graph.n_nodes, 257)).astype(
        np.float32))
    dy = torch.from_numpy(rng.normal(size=(graph.n_nodes, 257)).astype(
        np.float32))
    g, g_t = _port(graph), _port(graph.transpose())

    def run():
        xg = x.clone().requires_grad_(True)
        y = maxk_spgemm(g, g_t, xg, 16)
        y.backward(dy)
        return y.detach(), xg.grad

    y_mask, dx_mask = run()
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    y_cbsr, dx_cbsr = run()
    monkeypatch.delenv("MAXK_FUSED_MASK")
    monkeypatch.setattr(port_spgemm, "CBSR_GATHER_MODE", True)
    y, dx = run()
    assert k5_calls == []
    assert torch.equal(y, y_cbsr) and torch.equal(dx, dx_cbsr)
    assert not torch.equal(dx, dx_mask)


def test_k5_wrapper_refuses_what_it_cannot_take():
    g = _port(random_graph(8, 2.0, seed=1))
    sel = torch.zeros(8, 4, dtype=torch.uint8)
    for values, selector, dim in (
            (torch.ones(8, 4), sel.to(torch.int32), 64),   # not uint8
            (torch.ones(8, 4), sel, 257),                   # dim > 256
            (torch.ones(8, 129), torch.zeros(8, 129, dtype=torch.uint8),
             256),                                          # k > 128
            (torch.ones(7, 4), sel[:7], 64)):               # rows != n_cols
        with pytest.raises(ValueError):
            spgemm_cbsr_csr(g, values, selector, dim)


def test_sage_step_under_flag_matches_cbsr_route(monkeypatch):
    """One SAGE step at bf16 compute: the same loss as the CBSR route
    (MAXK_FUSED_MASK=0) within rtol 1e-6. On the card K5 and K2 both fuse
    each product into its sum and the losses are equal (chip_smoke.py
    phase 19); K2's plain version rounds the product first."""
    ds = make_synthetic_dataset(n_nodes=300, avg_degree=8.0, n_classes=5,
                                in_size=24, seed=3)
    cfg = types.SimpleNamespace(
        model="sage", hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.5,
        norm=True, nonlinear="maxk", w_lr=0.01, w_weight_decay=0.0,
        enable_lookahead=False, seed=97, compute_dtype="bfloat16",
        device="cpu")
    monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    cbsr_loss = float(Trainer(cfg, ds).train_step())
    monkeypatch.delenv("MAXK_FUSED_MASK")
    monkeypatch.setattr(port_spgemm, "CBSR_GATHER_MODE", True)
    calls = []
    monkeypatch.setattr(port_spgemm, "spgemm_cbsr_csr",
                        lambda *a: calls.append(1) or spgemm_cbsr_csr(*a))
    loss = float(Trainer(cfg, ds).train_step())
    assert len(calls) == cfg.hidden_layers
    np.testing.assert_allclose(loss, cbsr_loss, rtol=1e-6)
