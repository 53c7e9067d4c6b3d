"""The port's halo plan and row sharding vs maxk_tpu.parallel, on the host.

No process group: ``plan_halo``'s send lists equal the JAX package's
``shard_graph(..., row_block=8, edge_tile=32, halo=True,
col_part_rows=0).send_idx`` up to its zero padding, and the most rows a
pair exchanges is JAX's ``halo_rows`` before its round-up to 8 (at V =
256 both packages give a shard the same rows). Each shard's renumbered
columns, read through a table built on the host as the exchange builds
it, are its original global columns, and K2's plain version on that
table gives the single-device rows bit for bit.
"""

import numpy as np
import pytest
import torch

from maxk_tpu.parallel.partition import shard_graph as jax_shard_graph
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr_plain
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.parallel.partition import (local_rows, pad_nodes,
                                               shard_graph)

from conftest import random_graph


def _graph(v=256, seed=5):
    g = random_graph(v, 8.0, seed=seed, power_law=True)
    return g, CSRGraph(g.indptr, g.indices, g.values)


def _table_ids(sharded, s):
    """Global node id of each row of shard s's [local | received] table,
    as halo_exchange lays it out."""
    rows = sharded.rows_per_shard
    ids = [np.arange(s * rows, (s + 1) * rows)]
    ids += [p * rows + sharded.halo.send[p][s]
            for p in range(sharded.n_shards)]
    return np.concatenate(ids)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_send_lists_equal_jax(n_shards):
    jg, csr = _graph()
    ref = jax_shard_graph(jg, n_shards, row_block=8, edge_tile=32,
                          halo=True, col_part_rows=0)
    sg = shard_graph(csr, n_shards)
    assert sg.rows_per_shard == ref.rows_per_shard
    send_ref = np.asarray(ref.send_idx)
    for src in range(n_shards):
        for dst in range(n_shards):
            mine = sg.halo.send[src][dst]
            assert src != dst or mine.size == 0
            np.testing.assert_array_equal(send_ref[src, dst, :mine.size],
                                          mine)
            assert not send_ref[src, dst, mine.size:].any()
    h = sg.halo.halo_rows
    assert h > 0 and -(-h // 8) * 8 == ref.halo_rows
    assert h == max(len(lst) for row in sg.halo.send for lst in row)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_columns_and_rows_bit_equal_one_device(n_shards):
    _, csr = _graph(v=301, seed=9)       # the last shard is padded
    x = np.random.default_rng(1).normal(size=(301, 16)).astype(np.float32)
    want = spmm_csr_plain(DeviceCSR.from_csr(csr, "cpu"),
                          torch.from_numpy(x)).numpy()
    sg = shard_graph(csr, n_shards)
    rows = sg.rows_per_shard
    x_pad = pad_nodes(x, sg.n_nodes_padded)
    got = []
    for s in range(n_shards):
        shard = sg.shards[s]
        ids = _table_ids(sg, s)
        assert ids.shape[0] == sg.n_cols(s)
        e0, e1 = (pad_nodes(csr.indptr, sg.n_nodes_padded + 1,
                            csr.indptr[-1])[[s * rows, (s + 1) * rows]])
        np.testing.assert_array_equal(ids[shard.indices],
                                      csr.indices[e0:e1])
        g = DeviceCSR.from_csr(shard, "cpu", n_cols=ids.shape[0])
        np.testing.assert_array_equal(x_pad[s * rows:(s + 1) * rows],
                                      local_rows(x, sg, s))
        got.append(spmm_csr_plain(g, torch.from_numpy(x_pad[ids])).numpy())
    np.testing.assert_array_equal(np.concatenate(got)[:301], want)


def test_all_gather_mode_keeps_global_columns():
    _, csr = _graph()
    sg = shard_graph(csr, 2, halo=False)
    assert sg.gather and sg.halo is None
    assert sg.n_cols(0) == sg.n_cols(1) == 256
    np.testing.assert_array_equal(
        np.concatenate([s.indices for s in sg.shards]), csr.indices)


def test_no_cross_shard_edges_needs_no_exchange():
    """A block-diagonal graph: every shard's edges stay in its rows, so
    there is no plan and the columns are rebased to local ids
    (tests/test_parallel.py::test_halo_locality_no_cross_edges)."""
    rng = np.random.default_rng(7)
    n, per, s = 160, 40, 4
    src = np.concatenate([rng.integers(i * per, (i + 1) * per, 100)
                          for i in range(s)])
    dst = np.concatenate([rng.integers(i * per, (i + 1) * per, 100)
                          for i in range(s)])
    csr = CSRGraph.from_coo(src, dst.astype(np.int32), n)
    sg = shard_graph(csr, s)
    assert sg.halo is None and not sg.gather
    for i, shard in enumerate(sg.shards):
        assert sg.n_cols(i) == per
        assert shard.indices.min() >= 0 and shard.indices.max() < per
