"""The opt-in compute modes ("int8", "int8_rowscale") and hub-column
densification in the port vs maxk_tpu.

- The quantized tables are bit-equal: ``quantize_columns`` to the JAX
  package's ``_pack_x(x, "int8")`` and K6's int8 mode (its plain version
  here) to ``_rowscale_int8_table``, their int8 quads unpacked in the test.
- ``cbsr_expand`` (K6's plain version) equals the JAX expansion, also at
  bfloat16 and with selectors out of range (dropped on both sides), up to
  the sign of a zero (``==`` holds -0.0 equal to +0.0).
- The products under the int8 modes differ from the JAX package's by
  design only in where bfloat16 rounds: the JAX scans may round the
  one-hot operand and the edge weight (``vals * scale`` under the row
  scale) to bfloat16, the port keeps them float32. Per element that is at
  most 2**-8 of the sum of |terms| (``_quant_bound``: terms w_e * q * scale),
  plus the float32 bound of two summation orders, 2 n 2**-24 of the same
  sum, with n the row's edge count. The JAX tests' own bounds are held
  too (``tests/test_maxk_cbsr.py``: mean err / scale < 5e-3, none > 0.1).
- Hub graphs: the split is bit-equal to ``split_hub_columns``; spmm,
  spgemm_forward_cbsr and maxk_spgemm with their gradients match the JAX
  package on the same split (float32: within two summation orders, or
  rtol 1e-5, atol 1e-5); row shards refuse hubs; the split is off by
  default.
- SAGE under compute_dtype="int8", from flax weights: one forward and one
  backward against the JAX model.
- Torch runs one thread here (the suite's workers share the cores).

Graphs have 300 nodes; each JAX reference is jitted once per module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
import maxk_tpu
from maxk_tpu.models.models import (GraphBundle as JaxGraphBundle,
                                    build_model as jax_build_model)
from maxk_tpu.ops import graph as jax_graph
from maxk_tpu.ops.cbsr import cbsr_expand as jax_cbsr_expand
from maxk_tpu.ops.graph import build_tiled_graph
from maxk_tpu.ops.spgemm import (_rowscale_int8_table,
                                 spgemm_forward_cbsr as jax_forward_cbsr)
from maxk_tpu.ops.spmm import _pack_x, _unpack_int8_quads, spmm_t as jax_spmm_t
from maxk_tpu.train.loop import masked_loss as jax_masked_loss
from maxk_tpu_torch.models.convert import params_from_flax
from maxk_tpu_torch.models.models import GraphBundle, build_model
from maxk_tpu_torch.ops import graph as port_graph
from maxk_tpu_torch.ops.cbsr import cbsr_expand, cbsr_expand_int8, cbsr_topk
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_plain
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, split_hub_columns
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spgemm_forward_cbsr
from maxk_tpu_torch.ops.spmm import quantize_columns, spmm, spmm_t
from maxk_tpu_torch.train.loop import masked_loss

from conftest import random_graph

V = 300


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_after_module():
    yield
    jax.clear_caches()


# The suite runs several workers on the cores: one torch thread each here
# (as tests/test_torch_train_bench.py), where the port's plain versions
# run on graphs of a few hundred nodes.
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _graph(kind: str) -> CSRGraph:
    g = random_graph(V, 10.0, seed=21, power_law=kind == "power_law")
    g = g.normalize("mean")
    return CSRGraph(g.indptr, g.indices, g.values)


def _jax_csr(g: CSRGraph):
    return jax_graph.CSRGraph(g.indptr, g.indices, g.values)


# Few, large edge tiles: the JAX scans compile in a fraction of the time
# of the default layout, and the layout changes only their summation order.
TILES = dict(row_block=128, edge_tile=8192)


def _tg(g: CSRGraph, **kw):
    return build_tiled_graph(_jax_csr(g), **TILES, **kw)


def _x(d: int, seed: int) -> np.ndarray:
    """Columns of very different magnitudes, so per-column scales differ."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, d))
            * 10.0 ** rng.uniform(-2, 2, size=(1, d))).astype(np.float32)


def _unpack(quads) -> np.ndarray:
    """The JAX package's int8 quads back to a (V, D) int8 array."""
    return np.concatenate([np.asarray(u) for u in _unpack_int8_quads(
        jnp.asarray(quads))], axis=1).astype(np.int8)


def _dense(g: CSRGraph, absolute: bool = False) -> np.ndarray:
    """A (or |A|) as a dense float64 (V, V) matrix."""
    vals = g.values.astype(np.float64)
    a = np.zeros((V, V))
    np.add.at(a, g.to_coo(), np.abs(vals) if absolute else vals)
    return a


def _quant_bound(g: CSRGraph, q: torch.Tensor, scale: torch.Tensor,
                 row_scale: bool) -> np.ndarray:
    """(2**-8 + 2 n_r 2**-24) * sum_e |vals_e| |q[col_e]| scale: the JAX
    package's bfloat16 rounding of the weights plus two float32 orders."""
    a = _dense(g, absolute=True)
    qa = np.abs(q.double().numpy())
    s = scale.double().numpy()
    terms = a @ (qa * s[:, None]) if row_scale else (a @ qa) * s
    n = np.diff(g.indptr)[:, None]
    return (2.0 ** -8 + 2 * n * 2.0 ** -24) * terms + 1e-30


def _order_bound(g: CSRGraph, xa: np.ndarray, extra: int = 0) -> np.ndarray:
    """2 (n_r + extra) 2**-24 * sum_e |vals_e| |x[col_e]|: two float32
    summation orders of row r's n_r edges and `extra` more terms."""
    n = np.diff(g.indptr)[:, None] + extra
    return 2 * n * 2.0 ** -24 * (_dense(g, absolute=True) @ xa) + 1e-30


# -- the quantized tables ---------------------------------------------------

@pytest.mark.parametrize("d", [64, 96])
def test_quantize_columns_bit_equal_jax(d):
    x = _x(d, seed=d)
    packed, scale = jax.jit(lambda a: _pack_x(a, "int8")[:2])(
        jnp.asarray(x))
    q, s = quantize_columns(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(scale).view(np.int32))
    np.testing.assert_array_equal(q.numpy(), _unpack(packed))


_JIT_ROWSCALE = jax.jit(_rowscale_int8_table, static_argnums=2)
_JIT_EXPAND = jax.jit(jax_cbsr_expand, static_argnums=2)


@pytest.mark.parametrize("sel_dtype", [torch.int32, torch.uint8])
@pytest.mark.parametrize("k", [1, 32])
def test_rowscale_table_bit_equal_jax(k, sel_dtype):
    d = 64
    x = _x(d, seed=k)
    v, s = maxk_tpu.cbsr_topk(jnp.asarray(x), k)
    table = np.asarray(_JIT_ROWSCALE(v, s, d))
    q, scale = cbsr_expand_int8(torch.from_numpy(np.array(v)),
                                torch.from_numpy(np.array(s)).to(sel_dtype),
                                d)
    np.testing.assert_array_equal(q.numpy(), _unpack(table[:, :d // 4]))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  table[:, d // 4])


@pytest.mark.parametrize("value_dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("k,d", [(8, 61), (64, 256)])
def test_cbsr_expand_matches_jax(k, d, value_dtype, out_dtype):
    x = _x(d, seed=k + d)
    v, s = maxk_tpu.cbsr_topk(jnp.asarray(x), k)
    v_t = torch.from_numpy(np.array(v)).to(value_dtype)
    out = cbsr_expand(v_t, torch.from_numpy(np.array(s)), d, out_dtype)
    assert out.dtype == (out_dtype or value_dtype)
    ref = np.asarray(_JIT_EXPAND(jnp.asarray(v_t.float().numpy()), s, d))
    want = torch.from_numpy(np.array(ref)).to(out.dtype).float().numpy()
    np.testing.assert_array_equal(out.float().numpy(), want)


def test_cbsr_expand_drops_out_of_range_selectors():
    """A selector outside [0, dim) writes nothing, as the JAX chain's
    compare never meets it; the int8 row scale still counts its value."""
    d = 16
    v = torch.tensor([[1.0, -2.0, 3.0], [4.0, 5.0, -6.0]])
    s = torch.tensor([[0, 16, 5], [-1, 15, 40]], dtype=torch.int32)
    out = cbsr_expand(v, s, d)
    ref = np.asarray(_JIT_EXPAND(jnp.asarray(v.numpy()),
                                 jnp.asarray(s.numpy()), d))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0].tolist() == [1.0] + [0.0] * 4 + [3.0] + [0.0] * 10
    q, scale = cbsr_expand_int8(v, s, d)
    table = np.asarray(_JIT_ROWSCALE(jnp.asarray(v.numpy()),
                                     jnp.asarray(s.numpy()), d))
    np.testing.assert_array_equal(q.numpy(), _unpack(table[:, :d // 4]))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  table[:, d // 4])


# -- spmm and spmm_t under "int8" -------------------------------------------

@functools.cache
def _jax_spmm_t_int8(kind: str, d: int):
    """(y, dx) of the JAX package's spmm_t under "int8"."""
    g = _graph(kind)
    tg, tg_t = _tg(g), _tg(
        g.transpose())
    x, dy = _x(d, 1), _x(d, 2)

    @jax.jit
    def run(a, b):
        y, vjp = jax.vjp(lambda z: jax_spmm_t(
            tg, tg_t, z, compute_dtype="int8"), a)
        return y, vjp(b)[0]
    y, dx = run(jnp.asarray(x), jnp.asarray(dy))
    return x, dy, np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("seg_len", [256, 4])
def test_spmm_t_int8_matches_jax(seg_len, kind="power_law"):
    """Forward and dx of spmm_t under "int8" (its forward is spmm's), at
    the default segment length and at 4, where most rows are summed from
    partials."""
    d = 64
    g = _graph(kind)
    x, dy, y_ref, dx_ref = _jax_spmm_t_int8(kind, d)
    dev = DeviceCSR.from_csr(g, "cpu", seg_len=seg_len)
    dev_t = DeviceCSR.from_csr(g.transpose(), "cpu", seg_len=seg_len)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = spmm_t(dev, dev_t, xt, "int8")
    y.backward(torch.from_numpy(dy))
    for out, ref, a, t in ((y.detach(), y_ref, g, x),
                           (xt.grad, dx_ref, g.transpose(), dy)):
        q, scale = quantize_columns(torch.from_numpy(t))
        assert np.all(np.abs(out.numpy() - ref)
                      <= _quant_bound(a, q, scale, False))


def test_spmm_int8_odd_width_computes_in_bf16():
    """At D % 4 != 0 "int8" computes in bfloat16, as the JAX package's
    _pack_x falls through to it: equal to the port's own bfloat16."""
    dev = DeviceCSR.from_csr(_graph("uniform"), "cpu")
    x = torch.from_numpy(_x(62, 3))
    assert torch.equal(spmm(dev, x, "int8"), spmm(dev, x, "bfloat16"))


def test_spmm_int8_plain_is_the_dequantized_product():
    """K7's plain version, both scale modes, against float64 A @ dequant."""
    g = _graph("power_law")
    dev = DeviceCSR.from_csr(g, "cpu", seg_len=4)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-127, 128, (V, 32)).astype(np.int8))
    a = _dense(g)
    for row_scale, n in ((False, 32), (True, V)):
        scale = torch.from_numpy(rng.uniform(0.01, 1, n).astype(np.float32))
        out = spmm_int8_plain(dev, q, scale, row_scale).numpy()
        deq = q.double().numpy() * (scale.double().numpy()[:, None]
                                    if row_scale else scale.double().numpy())
        # float32 against float64: the row's n_r terms and the scaling.
        assert np.all(np.abs(out - a @ deq)
                      <= _order_bound(g, np.abs(deq), 1))


# -- the CBSR forward under "int8_rowscale" and "int8" -----------------------

_JIT_FORWARD_CBSR = jax.jit(jax_forward_cbsr,
                            static_argnames=("dim", "compute_dtype"))


def test_spgemm_forward_cbsr_rowscale_on_hubs_matches_jax():
    """The row-scaled table on a hub graph: its hub rows expanded (K6),
    then the slab matmul in bfloat16, on both sides."""
    d, k = 64, 8
    g = _skewed()
    x = np.random.default_rng(9).uniform(0, 1, (V, d)).astype(np.float32)
    v, s = maxk_tpu.cbsr_topk(jnp.asarray(x), k)
    ref = np.asarray(_JIT_FORWARD_CBSR(_tg(g, hub_cols=128), v, s, d,
                                       compute_dtype="int8_rowscale"))
    v_t, s_t = torch.from_numpy(np.array(v)), torch.from_numpy(np.array(s))
    dev = DeviceCSR.from_csr(g, "cpu", hub_cols=128)
    assert dev.hub_ids is not None
    out = spgemm_forward_cbsr(dev, v_t, s_t, d, "int8_rowscale").numpy()
    q, scale = cbsr_expand_int8(v_t, s_t, d)
    # The bound of all the edges' terms covers the slab's too (both sides
    # round its operands to bfloat16 alike).
    assert np.all(np.abs(out - ref) <= _quant_bound(g, q, scale, True))
    # The JAX test's bounds (tests/test_maxk_cbsr.py), against the
    # unquantized product.
    dense = _dense(g) @ cbsr_expand(v_t, s_t, d).double().numpy()
    err = np.abs(out - dense) / max(1.0, np.abs(dense).mean())
    assert (err > 0.1).sum() == 0 and err.mean() < 5e-3


@functools.cache
def _jax_maxk_spgemm_rowscale(k: int, d: int):
    g = _graph("uniform")
    tg, tg_t = _tg(g), _tg(
        g.transpose())
    x = np.random.default_rng(k).normal(size=(V, d)).astype(np.float32)
    dy = np.random.default_rng(k + 1).normal(size=(V, d)).astype(np.float32)

    @jax.jit
    def run(a, b):
        y, vjp = jax.vjp(lambda z: maxk_tpu.maxk_spgemm(
            tg, tg_t, z, k, compute_dtype="int8_rowscale"), a)
        return y, vjp(b)[0]
    y, dx = run(jnp.asarray(x), jnp.asarray(dy))
    return x, dy, np.asarray(y), np.asarray(dx, np.float32)


def test_maxk_spgemm_rowscale_matches_jax():
    """Forward to the per-element bound; the gradient, computed in
    bfloat16 on both sides (the JAX package's _resolve_cd), to the
    reference tolerance, mean error < 1e-3, and on the same support."""
    k, d = 16, 64
    g = _graph("uniform")
    x, dy, y_ref, dx_ref = _jax_maxk_spgemm_rowscale(k, d)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxk_spgemm(DeviceCSR.from_csr(g, "cpu"),
                    DeviceCSR.from_csr(g.transpose(), "cpu"), xt, k,
                    "int8_rowscale")
    y.backward(torch.from_numpy(dy))
    v, s = cbsr_topk(torch.from_numpy(x), k)
    q, scale = cbsr_expand_int8(v, s, d)
    assert np.all(np.abs(y.detach().numpy() - y_ref)
                  <= _quant_bound(g, q, scale, True))
    dx = xt.grad.numpy()
    np.testing.assert_array_equal(dx != 0, dx_ref != 0)
    assert np.mean(np.abs(dx - dx_ref)) < 1e-3


def test_int8_rowscale_refused_by_spmm_and_models():
    dev = DeviceCSR.from_csr(_graph("uniform"), "cpu")
    with pytest.raises(TypeError, match="int8_rowscale"):
        spmm(dev, torch.zeros(V, 8), "int8_rowscale")
    with pytest.raises(TypeError, match="int8_rowscale"):
        build_model("sage", 8, 16, 1, 3, compute_dtype="int8_rowscale")


# -- hub-column densification -----------------------------------------------

@functools.cache
def _skewed() -> CSRGraph:
    g = random_graph(V, 20.0, seed=2, power_law=True)
    return CSRGraph(g.indptr, g.indices, g.values)


def test_hub_split_bit_equal_jax():
    g = _skewed()
    ours = split_hub_columns(g, 128, 1)
    ref = jax_graph.split_hub_columns(_jax_csr(g), 128, 1)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1].view(np.int32),
                                  ref[1].view(np.int32))
    for name in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(ours[2], name),
                                      getattr(ref[2], name))
    dev = DeviceCSR.from_csr(g, "cpu", hub_cols=128)
    assert dev.hub_dense.shape == (V, 128)
    # n_edges still counts every edge, the slab's too.
    assert dev.n_edges == g.n_edges > int(dev.indices.shape[0])


def test_hub_spmm_int8_matches_jax():
    """spmm under "int8" on a hub graph: K7 on the residual's quantized
    table, and the slab's term on bfloat16-rounded x (float32 is covered
    by the maxk_spgemm test below)."""
    g, x = _skewed(), _x(64, 5)
    tg = _tg(g, hub_cols=128)
    assert tg.hub_ids is not None
    ref = np.asarray(jax.jit(lambda a: maxk_tpu.spmm(
        tg, a, compute_dtype="int8"))(jnp.asarray(x)))
    out = spmm(DeviceCSR.from_csr(g, "cpu", hub_cols=128),
               torch.from_numpy(x), "int8").numpy()
    q, scale = quantize_columns(torch.from_numpy(x))
    assert np.all(np.abs(out - ref) <= _quant_bound(g, q, scale, False))


@functools.cache
def _jax_hub_maxk_spgemm(mode):
    g = _skewed()
    tg = _tg(g, hub_cols=128)
    tg_t = _tg(g.transpose(), hub_cols=128)
    x, dy = _x(32, 6), _x(32, 7)

    @jax.jit
    def run(a, b):
        y, vjp = jax.vjp(lambda z: maxk_tpu.maxk_spgemm(
            tg, tg_t, z, 8, compute_dtype=mode), a)
        return y, vjp(b)[0]
    y, dx = run(jnp.asarray(x), jnp.asarray(dy))
    return x, dy, np.asarray(y), np.asarray(dx, np.float32)


@pytest.mark.parametrize("route", ["mask", "cbsr"])
def test_hub_maxk_spgemm_and_grad_match_jax(route, monkeypatch):
    """float32, on both routes of the port against the JAX package's mask
    route (its CBSR route gives the same values)."""
    if route == "cbsr":
        monkeypatch.setenv("MAXK_FUSED_MASK", "0")
    g = _skewed()
    x, dy, y_ref, dx_ref = _jax_hub_maxk_spgemm("float32")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxk_spgemm(DeviceCSR.from_csr(g, "cpu", hub_cols=128),
                    DeviceCSR.from_csr(g.transpose(), "cpu", hub_cols=128),
                    xt, 8, "float32")
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), dx_ref, rtol=1e-5,
                               atol=1e-5)


def test_hub_refused_on_shards_and_off_by_default(monkeypatch):
    g = _skewed()
    assert DeviceCSR.from_csr(g, "cpu").hub_ids is None
    assert DeviceCSR.from_csr(g, "cpu", hub_cols=0).hub_ids is None
    # The auto gate: off below HUB_MIN_NODES even when asked for.
    monkeypatch.setattr(port_graph, "_HUB_AUTO", True)
    assert DeviceCSR.from_csr(g, "cpu").hub_ids is None
    monkeypatch.setattr(port_graph, "HUB_MIN_NODES", 64)
    monkeypatch.setattr(port_graph, "HUB_MIN_DEG", 1)
    monkeypatch.setattr(port_graph, "_HUB_BREAK_EVEN_FRAC", 0.0)
    assert DeviceCSR.from_csr(g, "cpu").hub_ids is not None
    # A row shard with hubs: spmm refuses it (the slab would be dropped).
    hub = dataclasses.replace(DeviceCSR.from_csr(g, "cpu", hub_cols=128),
                              exchange=object())
    with pytest.raises(TypeError, match="single-device"):
        spmm(hub, torch.zeros(V, 8))


def test_symmetric_bundle_under_hubs_equals_hub_free():
    """Under hubs the symmetric mean transpose is built from the rescaled
    CSR (its slab holds A D^-1's values, not A's)."""
    csr = random_graph(V, 8.0, seed=3, power_law=True, weighted=False)
    rows, cols = csr.to_coo()
    sym = CSRGraph.from_coo(np.concatenate([rows, cols]),
                            np.concatenate([cols, rows]).astype(np.int32),
                            V)
    hub = GraphBundle.from_csr(sym, norms=("mean", "sym"), symmetric=True,
                               device="cpu", hub_cols=128)
    free = GraphBundle.from_csr(sym, norms=("mean", "sym"), symmetric=True,
                                device="cpu")
    assert hub.g_mean_t.hub_ids is not None and hub.g_sym_t is hub.g_sym
    x = torch.from_numpy(_x(16, 8))
    for name in ("g_mean", "g_mean_t", "g_sym"):
        a = spmm(getattr(hub, name), x, "float32")
        b = spmm(getattr(free, name), x, "float32")
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


# -- SAGE under "int8", from flax weights -----------------------------------

def test_sage_int8_step_matches_flax():
    """One train-mode forward (dropout 0) and backward of SAGE (one hidden
    layer) under compute_dtype="int8", the JAX model's weights carried by
    params_from_flax. Both quantize each aggregation's operand per
    column to the same int8 table unless the two sides' float32 orders
    put a value on either side of a rounding boundary, which these
    seeded inputs do not: the logits agree at rtol 1e-4, atol 1e-5, the
    gradients at rtol 1e-4, atol 1e-6 (test_torch_models' float32
    tolerances)."""
    f_in, hid, classes, k = 24, 32, 5, 8
    csr = random_graph(160, 6.0, seed=11, weighted=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(160, f_in)).astype(np.float32)
    labels, mask = rng.integers(0, classes, 160), rng.uniform(size=160) < 0.6
    kw = dict(maxk=k, feat_drop=0.0, norm=True, nonlinear="maxk",
              compute_dtype="int8")
    flax_model = jax_build_model("sage", f_in, hid, 1, classes, **kw)
    model = build_model("sage", f_in, hid, 1, classes, **kw)
    graphs = JaxGraphBundle.for_model(csr, "sage", **TILES)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(3), graphs,
                                      jnp.asarray(x))["params"]
    model.load_flax_params(jax.tree.map(np.asarray, params))

    def loss_fn(p):
        logits = flax_model.apply({"params": p}, graphs, jnp.asarray(x),
                                  training=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_masked_loss(logits, jnp.asarray(labels),
                               jnp.asarray(mask), False), logits

    (loss_ref, logits_ref), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    port_graphs = GraphBundle.for_model(
        CSRGraph(csr.indptr, csr.indices, csr.values), "sage", device="cpu")
    logits = model(port_graphs, torch.from_numpy(x), training=True)
    loss = masked_loss(logits, torch.from_numpy(labels),
                       torch.from_numpy(mask), False)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ref = params_from_flax(jax.tree.map(np.asarray, grads))
    named = dict(model.named_parameters())
    for key, g in ref.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
