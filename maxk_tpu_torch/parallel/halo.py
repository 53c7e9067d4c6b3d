"""Neighbour-selective halo exchange for row-partitioned graphs.

A shard's edges reach rows that other ranks own. Rather than gather
every row of x (``GatherSpec``, the all-gather mode), each rank receives
just the remote rows its edges touch (``maxk_tpu/parallel/halo.py``):

- At shard time (host, every rank alike), ``plan_halo`` takes, for each
  shard, the sorted unique remote columns of its edges. Those in peer
  p's row range are p's send list to that shard, and the shard's columns
  are renumbered into its ``[local rows | received rows]`` table, the
  received rows in peer order.
- At run time, ``halo_exchange`` gathers this rank's send rows
  (``index_select``), swaps them in one ``all_to_all_single`` and
  concatenates the received rows under the local ones.

The JAX package pads every pair's list to one length H, rounded up to 8,
because XLA needs static shapes. Here each pair sends exactly its rows
(``send_counts``/``recv_counts``), so the lists equal JAX's up to its
zero padding. There is no column-parted variant (that is a TPU gather
workaround) and no local-first overlap of the exchange with K2 yet: K2
runs once over the table, after the exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.parallel.mesh import (GraphGroup, all_gather_rows,
                                          all_to_all_rows)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Every shard's exchange, on the host.

    send[src][dst]: the local row ids (sorted, int64) shard src sends to
    shard dst; empty where src == dst.
    """

    send: list

    @property
    def halo_rows(self) -> int:
        """H: the most rows one shard sends another."""
        return max((len(lst) for row in self.send for lst in row),
                   default=0)

    def spec(self, group: GraphGroup) -> "HaloSpec":
        """This rank's runtime exchange."""
        r = group.rank
        send = self.send[r]
        idx = np.concatenate(send) if send else np.zeros(0, np.int64)
        return HaloSpec(
            send_idx=torch.from_numpy(idx.astype(np.int64)).to(group.device),
            send_counts=tuple(len(lst) for lst in send),
            recv_counts=tuple(len(row[r]) for row in self.send),
            group=group)


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """One rank's exchange: the rows it sends to each rank (send_idx, in
    rank order, ``send_counts`` of them each) and the rows it receives
    from each (``recv_counts``), over ``group``."""

    send_idx: torch.Tensor     # (sum(send_counts),) int64 local rows
    send_counts: tuple
    recv_counts: tuple
    group: GraphGroup
    # The table is local rows and halo rows, not every rank's: the CBSR
    # forward expands it, as the JAX package's halo mode does (not a field).
    whole_table = False

    def table(self, x_local: torch.Tensor) -> torch.Tensor:
        return halo_exchange(x_local, self, self.group)


@dataclasses.dataclass(frozen=True)
class GatherSpec:
    """The all-gather mode: every rank's rows, in rank order (the JAX
    package's ``gather_axis``)."""

    group: GraphGroup
    # The table is every rank's rows, which K5 reads under
    # CBSR_GATHER_MODE (ops/spgemm.py; not a field).
    whole_table = True

    def table(self, x_local: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(x_local, self.group)


def halo_exchange(x_local: torch.Tensor, spec: HaloSpec,
                  group: GraphGroup) -> torch.Tensor:
    """The (n_local + received, ...) table of a (n_local, ...) node array:
    local rows first, then each peer's rows in rank order, as the
    shard's renumbered columns index it."""
    send = x_local.index_select(0, spec.send_idx)
    recv = all_to_all_rows(send, spec.send_counts, spec.recv_counts, group)
    return torch.cat([x_local, recv])


def halo_nbytes(spec: HaloSpec, dim: int, itemsize: int = 4) -> int:
    """Bytes this rank sends per exchange of rows of `dim` items."""
    return sum(spec.send_counts) * dim * itemsize


def plan_halo(shards: list, rows_per_shard: int
              ) -> tuple[list, Optional[HaloPlan]]:
    """Plan the exchange of row shards whose columns are global.

    Returns (shards with columns in their ``[local | received]`` table
    space, the plan), or (shards with local columns, None) when no edge
    crosses a shard boundary. Each shard's remote columns are sorted
    unique once (``np.unique``) and renumbered by ``searchsorted``: the
    peers' row ranges are in rank order, so that order is the table's.
    """
    n = len(shards)
    send = [[np.zeros(0, np.int64) for _ in range(n)] for _ in range(n)]
    out = []
    crossing = False
    bounds = np.arange(n + 1, dtype=np.int64) * rows_per_shard
    for s, g in enumerate(shards):
        cols = g.indices.astype(np.int64)
        lo = s * rows_per_shard
        local = (cols >= lo) & (cols < lo + rows_per_shard)
        new = cols - lo
        remote = cols[~local]
        if remote.size:
            crossing = True
            uniq = np.unique(remote)
            new[~local] = rows_per_shard + np.searchsorted(uniq, remote)
            cut = np.searchsorted(uniq, bounds)
            for p in range(n):
                if p != s:
                    send[p][s] = uniq[cut[p]:cut[p + 1]] - p * rows_per_shard
        out.append(CSRGraph(g.indptr, new.astype(np.int32), g.values))
    return out, (HaloPlan(send=send) if crossing else None)
