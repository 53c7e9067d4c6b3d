"""K2's work: the operations and bytes of one launch of the CSR SpMM
(``spmm_segment_kernel`` then ``spmm_finish_kernel``), out = A @ x.

Operations: 2 E D (a multiply and an add a gathered value). Bytes: each
input byte read once and the output written once, whatever the kernel
reads again: the (V, D) table in the gather dtype, ``indptr`` (int64),
the columns (int32) and values (float32) of every edge, the segment plan
(a row, a first edge and a partials slot a segment; a row and a range of
partials a finish row) and the (V, D) float32 output. The plan cuts every
row into segments of at most ``SEG_LEN`` edges; a row of several is
finished by the second kernel, and so is a row of none.
"""

from __future__ import annotations

import torch

SEG_LEN = 256
OP_FRAGMENTS = ("spmm_segment_kernel", "spmm_finish_kernel")


def plan_sizes(degrees: torch.Tensor, seg_len: int = SEG_LEN
               ) -> tuple[int, int]:
    """(segments, finish rows) of the plan for rows of these degrees."""
    segs = (degrees + seg_len - 1) // seg_len
    n_fin = int(((segs > 1) | (segs == 0)).sum())
    return int(segs.sum()), n_fin


def launch_cost(n_nodes: int, n_edges: int, n_segments: int, n_fin: int,
                d: int, table_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one launch at D = d columns."""
    flops = 2 * n_edges * d
    nbytes = (n_nodes * d * table_bytes          # x, gathered
              + (n_nodes + 1) * 8                # indptr
              + n_edges * (4 + 4)                # columns, values
              + n_segments * (4 + 8 + 4)         # row, start, slot
              + n_fin * 4 + (n_fin + 1) * 8      # finish rows, ranges
              + n_nodes * d * 4)                 # out
    return flops, nbytes
