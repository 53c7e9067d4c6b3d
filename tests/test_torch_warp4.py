"""The port's warp4 module vs maxk_tpu's, and K2's segment plan.

generate_warp4 is bit-identical to the JAX package's for every
warp_max_nz; save/load round-trips; validate_warp4 rejects the plans the
JAX one rejects. The segment plan built on it covers each edge exactly
once, in segments of at most seg_len edges, and each zero-degree row
once.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.data import warp4 as jax_warp4
from maxk_tpu.ops.graph import CSRGraph as JaxCSRGraph
from maxk_tpu_torch.data import warp4
from maxk_tpu_torch.ops.graph import (SEG_LEN, CSRGraph, DeviceCSR,
                                      SegmentPlan)

from conftest import random_graph


def _with_empty_rows(n: int, seed: int) -> JaxCSRGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 8 * n)
    src = src[src % 3 != 0]
    dst = rng.integers(0, n, src.shape[0]).astype(np.int32)
    return JaxCSRGraph.from_coo(src, dst, n)


GRAPHS = {
    "uniform": lambda: random_graph(300, 8.0, seed=1),
    # Rows are the skewed side here, so the plan splits hub rows.
    "power_law": lambda: random_graph(400, 12.0, seed=2,
                                      power_law=True).transpose(),
    "empty_rows": lambda: _with_empty_rows(300, seed=3),
}


@pytest.fixture(params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


def _port(g) -> CSRGraph:
    return CSRGraph(g.indptr, g.indices, g.values)


def test_constants_match():
    assert (warp4.NUM_WARPS, warp4.WARP_MAX_NZ, warp4.META_DIRNAME) == (
        jax_warp4.NUM_WARPS, jax_warp4.WARP_MAX_NZ, jax_warp4.META_DIRNAME)


@pytest.mark.parametrize("warp_max_nz", [1, 4, 64])
def test_generate_bit_identical_to_jax(graph, warp_max_nz):
    ours = warp4.generate_warp4(_port(graph), warp_max_nz)
    ref = jax_warp4.generate_warp4(graph, warp_max_nz)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_generate_all_rows_empty():
    g = CSRGraph(np.zeros(5, np.int64), np.zeros(0, np.int32))
    assert warp4.generate_warp4(g).shape == (0, 4)


def test_save_load_roundtrip(graph, tmp_path):
    w = warp4.generate_warp4(_port(graph))
    path = warp4.save_warp4(w, tmp_path, "g")
    assert path == tmp_path / warp4.META_DIRNAME / "g.warp4"
    back = warp4.load_warp4(path)
    np.testing.assert_array_equal(back, w)
    # The files are the same bytes either package writes.
    np.testing.assert_array_equal(jax_warp4.load_warp4(path), w)
    warp4.validate_warp4(back, _port(graph))


def test_load_rejects_ragged_file(tmp_path):
    path = tmp_path / "bad.warp4"
    np.arange(6, dtype=np.int32).tofile(path)
    for mod in (warp4, jax_warp4):
        with pytest.raises(ValueError, match="multiple of 4"):
            mod.load_warp4(path)


def _broken(w: np.ndarray, how: str) -> np.ndarray:
    w = w.copy()
    if how == "len_zero":
        w[0, 2] = 0
    elif how == "len_too_long":
        w[0, 2] = warp4.WARP_MAX_NZ + 1
    elif how == "drop_warp":
        w = w[1:]
    elif how == "shift_loc":
        w[-1, 1] += 1
    return w


@pytest.mark.parametrize("how", ["len_zero", "len_too_long", "drop_warp",
                                 "shift_loc", "wrong_graph"])
def test_validate_rejects_what_jax_rejects(how):
    g = random_graph(100, 10.0, seed=1)
    w = warp4.generate_warp4(_port(g))
    if how == "wrong_graph":
        g = random_graph(100, 12.0, seed=2)
    else:
        w = _broken(w, how)
    with pytest.raises(ValueError) as ours:
        warp4.validate_warp4(w, _port(g))
    with pytest.raises(ValueError) as ref:
        jax_warp4.validate_warp4(w, g)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seg_len", [2, 8, 256])
def test_plan_covers_each_edge_and_empty_row_once(graph, seg_len):
    csr = _port(graph)
    plan = SegmentPlan.build(csr, seg_len)
    row = plan.seg_row.numpy().astype(np.int64)
    start = plan.seg_start.numpy()
    end = np.minimum(start + seg_len, csr.indptr[row + 1])
    assert (start >= csr.indptr[row]).all() and (end > start).all()
    hits = np.zeros(csr.n_edges, np.int64)
    for a, b in zip(start, end):
        hits[a:b] += 1
    assert (hits == 1).all()
    # Each row's segments are consecutive and in edge order.
    assert (np.diff(row) >= 0).all()
    same = np.diff(row) == 0
    assert (np.diff(start)[same] == seg_len).all()

    deg = np.diff(csr.indptr)
    per_row = -(-deg // seg_len)
    fin_row = plan.fin_row.numpy()
    fin_ptr = plan.fin_ptr.numpy()
    split = np.nonzero(per_row > 1)[0]
    empty = np.nonzero(deg == 0)[0]
    np.testing.assert_array_equal(fin_row, np.concatenate([split, empty]))
    np.testing.assert_array_equal(np.diff(fin_ptr),
                                  np.concatenate([per_row[split],
                                                  np.zeros(len(empty))]))
    # Split rows' segments own the partials rows in segment order; the
    # other segments write out.
    slot = plan.seg_slot.numpy()
    in_split = per_row[row] > 1
    np.testing.assert_array_equal(slot[in_split],
                                  np.arange(plan.n_partials))
    assert (slot[~in_split] == -1).all()
    assert plan.n_partials == fin_ptr[-1] == per_row[split].sum()


def test_plan_matches_warp4_rows_and_starts(graph):
    csr = _port(graph)
    plan = SegmentPlan.build(csr, 8)
    w = jax_warp4.generate_warp4(graph, 8)
    np.testing.assert_array_equal(plan.seg_row.numpy(), w[:, 0])
    np.testing.assert_array_equal(plan.seg_start.numpy(), w[:, 1])


def test_device_csr_carries_plan():
    csr = _port(random_graph(50, 4.0, seed=4))
    dev = DeviceCSR.from_csr(csr, "cpu", seg_len=3)
    assert dev.plan.seg_len == 3
    assert dev.plan.seg_row.device == dev.indices.device
    assert DeviceCSR.from_csr(csr, "cpu").plan.seg_len == SEG_LEN
    with pytest.raises(ValueError, match="segment length"):
        SegmentPlan.build(csr, 0)
