"""1-D row partitioning of graphs and node arrays over the ranks.

Each shard owns an equal, contiguous block of ``ceil(V / S)`` rows of
the adjacency and the same rows of the features, labels and masks; the
last block is padded with empty rows. In halo mode (the default) a
shard's columns index its ``[local | received]`` table and it carries
its exchange plan (``parallel/halo.py``); with ``halo=False`` its
columns stay global and ops all-gather the operand, as the JAX package's
``gather_axis`` mode does (``maxk_tpu/parallel/partition.py``).
Partitioning runs once on the host, on every rank alike; each rank then
moves its own shard to its device (``ShardedGraph.local``).

The JAX package rounds a shard's rows up to its TPU row block; here the
rows are not rounded, and no tile or column part exists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from maxk_tpu_torch.models.models import GraphBundle, mean_transpose_values
from maxk_tpu_torch.ops.graph import SEG_LEN, CSRGraph, DeviceCSR
from maxk_tpu_torch.parallel.halo import GatherSpec, HaloPlan, plan_halo
from maxk_tpu_torch.parallel.mesh import GraphGroup


def pad_nodes(arr: np.ndarray, n_nodes_padded: int, fill=0) -> np.ndarray:
    """Pad a (V, ...) node array to the partitioned node count."""
    pad = n_nodes_padded - arr.shape[0]
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Every shard of one graph, on the host.

    shards[s]: shard s's rows as a CSRGraph; its columns index its
    ``[local | received]`` table (halo mode), the global rows (gather
    mode), or its own rows (no edge crosses a shard, or one shard).
    """

    shards: list
    rows_per_shard: int
    n_nodes_global: int
    n_edges: int
    halo: Optional[HaloPlan] = None
    gather: bool = False

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_nodes_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    def n_cols(self, rank: int) -> int:
        """Rows of the table rank's columns index."""
        if self.gather:
            return self.n_nodes_padded
        if self.halo is None:
            return self.rows_per_shard
        return self.rows_per_shard + sum(
            len(row[rank]) for row in self.halo.send)

    def local(self, group: GraphGroup, seg_len: int = SEG_LEN) -> DeviceCSR:
        """This rank's shard on its device, with its exchange."""
        if self.halo is not None:
            exchange = self.halo.spec(group)
        elif self.gather:
            exchange = GatherSpec(group)
        else:
            exchange = None
        return DeviceCSR.from_csr(self.shards[group.rank], group.device,
                                  seg_len, n_cols=self.n_cols(group.rank),
                                  exchange=exchange, hub_cols=0)


def shard_graph(csr: CSRGraph, n_shards: int,
                halo: bool = True) -> ShardedGraph:
    """Split a CSR graph's rows into n_shards blocks of ceil(V / S) rows.

    A shard keeps each of its rows' edges in their order and only
    renumbers their columns, so K2 sums each row as on one device.
    halo=True (default) plans the halo exchange; halo=False keeps
    global columns for the all-gather mode.
    """
    v = csr.n_nodes
    rows = -(-v // n_shards)
    v_pad = rows * n_shards
    indptr = np.concatenate([
        csr.indptr, np.full(v_pad - v, csr.indptr[-1], np.int64)])
    shards = []
    for s in range(n_shards):
        e0, e1 = int(indptr[s * rows]), int(indptr[(s + 1) * rows])
        shards.append(CSRGraph(indptr[s * rows:(s + 1) * rows + 1] - e0,
                               csr.indices[e0:e1], csr.values[e0:e1]))
    plan = None
    gather = False
    if n_shards > 1:
        if halo:
            shards, plan = plan_halo(shards, rows)
        else:
            gather = True
    return ShardedGraph(shards=shards, rows_per_shard=rows,
                        n_nodes_global=v, n_edges=csr.n_edges, halo=plan,
                        gather=gather)


@dataclasses.dataclass(frozen=True)
class ShardedGraphBundle:
    """Sharded counterpart of models.GraphBundle (None where unused)."""

    g_mean: Optional[ShardedGraph] = None
    g_mean_t: Optional[ShardedGraph] = None
    g_sum: Optional[ShardedGraph] = None
    g_sum_t: Optional[ShardedGraph] = None
    g_sym: Optional[ShardedGraph] = None
    g_sym_t: Optional[ShardedGraph] = None

    @property
    def _any(self) -> ShardedGraph:
        for g in (self.g_mean, self.g_sum, self.g_sym):
            if g is not None:
                return g
        raise ValueError("empty ShardedGraphBundle")

    @property
    def n_nodes_padded(self) -> int:
        return self._any.n_nodes_padded

    @property
    def n_nodes_global(self) -> int:
        return self._any.n_nodes_global

    @property
    def rows_per_shard(self) -> int:
        return self._any.rows_per_shard


def shard_bundle(csr: CSRGraph, n_shards: int,
                 norms=("mean", "sum", "sym"), halo: bool = True,
                 symmetric: bool = False) -> ShardedGraphBundle:
    """Normalise the global graph, then shard it and its transpose, each
    by its own rows. The transposes are those of
    ``GraphBundle.from_csr``: with symmetric=True the sum and sym
    matrices are their own, and the mean one is A's structure with
    column-degree values."""
    built = {}
    for norm in norms:
        base = csr.normalize("none" if norm == "sum" else norm)
        built[f"g_{norm}"] = shard_graph(base, n_shards, halo)
        if symmetric and norm in ("sum", "sym"):
            t = built[f"g_{norm}"]
        elif symmetric and norm == "mean":
            t = shard_graph(csr.with_values(mean_transpose_values(csr)),
                            n_shards, halo)
        else:
            t = shard_graph(base.transpose(), n_shards, halo)
        built[f"g_{norm}_t"] = t
    return ShardedGraphBundle(**built)


def local_bundle(sharded: ShardedGraphBundle, group: GraphGroup,
                 seg_len: int = SEG_LEN) -> GraphBundle:
    """This rank's GraphBundle: its shards on its device (a matrix that is
    its own transpose shared, not moved twice), and how many of its rows
    are real nodes (``n_valid``; the last shard's padding is not)."""
    moved = {}

    def loc(g):
        if g is None:
            return None
        if id(g) not in moved:
            moved[id(g)] = g.local(group, seg_len)
        return moved[id(g)]

    rows = sharded.rows_per_shard
    n_valid = min(rows, max(0, sharded.n_nodes_global - group.rank * rows))
    return GraphBundle(
        g_mean=loc(sharded.g_mean), g_mean_t=loc(sharded.g_mean_t),
        g_sum=loc(sharded.g_sum), g_sum_t=loc(sharded.g_sum_t),
        g_sym=loc(sharded.g_sym), g_sym_t=loc(sharded.g_sym_t),
        n_valid=n_valid)


def shard_node_array(arr: np.ndarray, sharded, fill=0) -> np.ndarray:
    """Pad a (V, ...) node array to the sharded padded length."""
    n_pad = sharded if isinstance(sharded, int) else sharded.n_nodes_padded
    return pad_nodes(np.asarray(arr), n_pad, fill=fill)


def local_rows(arr: np.ndarray, sharded, rank: int, fill=0) -> np.ndarray:
    """Rank's block of a (V, ...) node array, padded rows filled."""
    rows = sharded.rows_per_shard
    return shard_node_array(arr, sharded, fill)[rank * rows:(rank + 1) * rows]
