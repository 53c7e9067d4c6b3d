"""GNNAdvisor-analog SAG baseline: neighbor-group SpMM, in torch ops.

The benchmark harness's second comparator, after the reference's
kernels/spmm_gnna.cu: the host splits each row's neighbor list into
groups of ``part_size = avg_degree`` (``build_part``,
spmm_gnna.cu:20-58,149-152); the kernel sums each group's neighbor rows
into a partial and flushes the partials into the output rows with
atomics (spmm_gnna.cu:60-140). Here:

- ``build_parts``: the same host-side grouping, a numpy copy of the JAX
  package's ``maxk_tpu/ops/gnna.py::build_parts`` (one (row,
  cols[part_size]) record a group, zero-weight padding slots);
- ``spmm_gnna``: each group's gather and sum, then an ``index_add_`` of
  the partials into their rows. These are torch ops, not GNNAdvisor's
  CUDA kernel. On CUDA ``index_add_`` adds with atomics, as the
  reference's flush does, in no fixed order: two calls may differ in the
  last bits of a row's sum.

Like the reference SAG kernel it is UNWEIGHTED (a pure neighbor sum; the
edge values are ignored) and exists as a benchmark comparator, not a
production path: the production SpMM is ``ops/spmm.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from maxk_tpu_torch.ops.graph import CSRGraph

# spmm_gnna gathers at most this many (slot, feature) values at once.
_CHUNK_ELEMS = 1 << 26

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class NeighborParts:
    """Host-built neighbor groups (the build_part output analog)."""

    cols: Array       # (G, P) int32 neighbor ids (0 on padding slots)
    weight: Array     # (G, P) float32 1.0 real / 0.0 padding
    row: Array        # (G,) int32 destination row per group
    part_size: int
    n_nodes: int

    @property
    def n_groups(self) -> int:
        return int(self.cols.shape[0])

    def to(self, device) -> "NeighborParts":
        """The same groups as torch tensors on `device`."""
        return dataclasses.replace(
            self, **{name: torch.as_tensor(getattr(self, name), device=device)
                     for name in ("cols", "weight", "row")})


def build_parts(csr: CSRGraph, part_size: Optional[int] = None,
                chunk_groups: int = 8192) -> NeighborParts:
    """Split every row's neighbors into groups of part_size
    (reference build_part, spmm_gnna.cu:20-58; partSize = average degree,
    main.cu usage via spmm_gnna.h)."""
    if part_size is None:
        part_size = max(1, int(round(csr.avg_degree)))
    deg = np.diff(csr.indptr).astype(np.int64)
    groups_per_row = -(-deg // part_size)
    g = int(groups_per_row.sum())
    g_pad = max(chunk_groups, -(-g // chunk_groups) * chunk_groups)

    row = np.zeros(g_pad, np.int32)
    cols = np.zeros((g_pad, part_size), np.int32)
    weight = np.zeros((g_pad, part_size), np.float32)

    rows_nz = np.nonzero(groups_per_row)[0]
    row[:g] = np.repeat(rows_nz, groups_per_row[rows_nz]).astype(np.int32)
    # Padding groups carry the LAST real row id, not 0, so that the group
    # rows stay sorted (their partials are all-zero either way, so the
    # target row is unaffected).
    if g and g < g_pad:
        row[g:] = row[g - 1]
    starts = np.concatenate([[0], np.cumsum(groups_per_row)[:-1]])
    intra = (np.arange(g) - np.repeat(starts[rows_nz],
                                      groups_per_row[rows_nz])) * part_size
    e0 = csr.indptr[row[:g].astype(np.int64)] + intra
    count = np.minimum(deg[row[:g].astype(np.int64)] - intra, part_size)
    # Slot-fill per group (vectorized over the fixed part_size).
    for j in range(part_size):
        live = j < count
        idx = np.minimum(e0 + j, csr.n_edges - 1)
        cols[:g, j] = np.where(live, csr.indices[idx], 0)
        weight[:g, j] = live.astype(np.float32)
    return NeighborParts(cols=cols, weight=weight, row=row,
                         part_size=part_size, n_nodes=csr.n_nodes)


def spmm_gnna(parts: NeighborParts, x: torch.Tensor) -> torch.Tensor:
    """Unweighted neighbor-sum SpMM over neighbor groups (SAG kernel
    analog, reference spmm_gnna.cu:60-140), (V, D) in x's dtype.

    Groups are taken in chunks of at most _CHUNK_ELEMS gathered values,
    to bound the gather's working set. Pass ``parts.to(x.device)`` to
    keep the groups' copy to the device out of every call.
    """
    dev, d = x.device, x.shape[1]
    cols, weight, row = (torch.as_tensor(a, device=dev)
                         for a in (parts.cols, parts.weight, parts.row))
    out = torch.zeros((parts.n_nodes, d), dtype=x.dtype, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(1, parts.part_size * d))
    for lo in range(0, parts.n_groups, chunk):
        hi = lo + chunk
        xg = x[cols[lo:hi].long()]                       # (chunk, P, D)
        partials = (weight[lo:hi, :, None].to(x.dtype) * xg).sum(dim=1)
        out.index_add_(0, row[lo:hi].long(), partials)
    return out
