"""Graph containers: host-side numpy CSR and the device-side DeviceCSR.

``CSRGraph`` is a numpy copy of the JAX package's host CSR (same
constructors, transforms and normalizations, bit-equal outputs). The
device form is plain CSR arrays on a torch device plus K2's segment plan
(``SegmentPlan``): the SpMM kernel (``csrc/spmm_csr.cu``) walks row
segments of at most ``SEG_LEN`` edges, so the TPU's row-block edge tiles
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from maxk_tpu_torch.data.warp4 import generate_warp4

# K2's segment length: a warp of the SpMM kernel sums at most this many
# consecutive edges of one row. Chosen by the sweep over
# {128, 256, 512, 1024} in chip_smoke.py's kernel phase (PERF.md).
SEG_LEN = 256


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    otherwise. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


@dataclasses.dataclass
class CSRGraph:
    """Host (numpy) CSR adjacency.

    indptr:  (V+1,) int64 row pointers
    indices: (E,)   int32 column indices
    values:  (E,)   float32 edge values (defaults to 1.0)
    """

    indptr: np.ndarray
    indices: np.ndarray
    values: Optional[np.ndarray] = None

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        if self.values is None:
            self.values = np.ones(self.indices.shape[0], dtype=np.float32)
        else:
            self.values = np.asarray(self.values, dtype=np.float32)

    @property
    def n_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.indices,
                           minlength=self.n_nodes).astype(np.int64)

    @property
    def avg_degree(self) -> float:
        return self.n_edges / max(1, self.n_nodes)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_coo(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 values: Optional[np.ndarray] = None) -> "CSRGraph":
        """Rows = src, columns = dst (stable in input order)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int32)
        if values is None:
            values = np.ones(src.shape[0], dtype=np.float32)
        order = np.argsort(src, kind="stable")
        counts = np.bincount(src, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr, dst[order],
                        np.asarray(values, np.float32)[order])

    def to_coo(self) -> tuple[np.ndarray, np.ndarray]:
        rows = np.repeat(np.arange(self.n_nodes, dtype=np.int64),
                         np.diff(self.indptr))
        return rows, self.indices.astype(np.int64)

    # -- structural transforms ---------------------------------------------

    def transpose(self) -> "CSRGraph":
        """CSC of A == CSR of A^T, carrying edge values across."""
        rows, cols = self.to_coo()
        return CSRGraph.from_coo(cols, rows.astype(np.int32), self.n_nodes,
                                 values=self.values)

    def remove_self_loops(self) -> "CSRGraph":
        rows, cols = self.to_coo()
        keep = rows != cols
        return CSRGraph.from_coo(rows[keep], cols[keep].astype(np.int32),
                                 self.n_nodes, values=self.values[keep])

    def add_self_loops(self, dedup: bool = True) -> "CSRGraph":
        """Add i->i edges with value 1.0, removing existing self-loops
        first (DGL AddSelfLoop semantics)."""
        g = self.remove_self_loops() if dedup else self
        rows, cols = g.to_coo()
        loop = np.arange(g.n_nodes, dtype=np.int64)
        rows = np.concatenate([rows, loop])
        cols = np.concatenate([cols, loop.astype(np.int32)])
        vals = np.concatenate([g.values, np.ones(g.n_nodes, np.float32)])
        return CSRGraph.from_coo(rows, cols.astype(np.int32), g.n_nodes, vals)

    def with_values(self, values: np.ndarray) -> "CSRGraph":
        return CSRGraph(self.indptr, self.indices, values)

    # -- normalizations (aggregator semantics) ------------------------------

    def normalize(self, mode: str) -> "CSRGraph":
        """Return a graph whose values implement an aggregation rule.

        mode='none': raw values (sum aggregation).
        mode='mean': value[e] /= out_degree(row(e)).
        mode='sym':  value[e] /= sqrt(d_out(row) * d_in(col)).
        """
        if mode == "none":
            return self
        rows, cols = self.to_coo()
        if mode == "mean":
            deg = np.maximum(np.diff(self.indptr), 1).astype(np.float32)
            vals = self.values / deg[rows]
        elif mode == "sym":
            d_out = np.maximum(np.diff(self.indptr), 1).astype(np.float32)
            d_in = np.maximum(self.in_degrees, 1).astype(np.float32)
            vals = self.values / (np.sqrt(d_out[rows]) * np.sqrt(d_in[cols]))
        else:
            raise ValueError(f"unknown normalization mode: {mode}")
        return self.with_values(vals.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """K2's work list: every row's edges cut into segments of at most
    ``seg_len`` consecutive edges (the warp4 split at that length).

    A row of one segment is written by that segment. A row of several
    (a split row) has each segment write float32 partial sums to its own
    row of a workspace, and a second pass sums them in segment order.
    That pass also writes the zero-degree rows, which have no segment,
    as zeros: they are its rows with an empty range of partials.
    """

    seg_len: int
    seg_row: torch.Tensor     # (n_seg,) int32, in row order
    seg_start: torch.Tensor   # (n_seg,) int64, first edge of the segment
    seg_slot: torch.Tensor    # (n_seg,) int32, its partials row, or -1
    fin_row: torch.Tensor     # (n_fin,) int32: split rows, then empty rows
    fin_ptr: torch.Tensor     # (n_fin+1,) int64 ranges of partials rows
    n_partials: int

    @staticmethod
    def build(csr: CSRGraph, seg_len: int = SEG_LEN,
              device="cpu") -> "SegmentPlan":
        if seg_len < 1:
            raise ValueError(f"segment length must be >= 1, got {seg_len}")
        row = generate_warp4(csr, seg_len)[:, 0].astype(np.int64)
        n_seg = row.shape[0]
        per_row = np.bincount(row, minlength=csr.n_nodes)
        first = np.cumsum(per_row) - per_row
        # warp4's loc is int32; the start is recomputed in int64 so that
        # E may pass 2**31.
        start = csr.indptr[row] + (np.arange(n_seg) - first[row]) * seg_len
        split = per_row > 1
        in_split = split[row]
        slot = np.full(n_seg, -1, np.int32)
        slot[in_split] = np.arange(int(in_split.sum()), dtype=np.int32)
        split_rows = np.nonzero(split)[0]
        fin_row = np.concatenate([split_rows, np.nonzero(per_row == 0)[0]])
        counts = np.zeros(fin_row.shape[0], np.int64)
        counts[:split_rows.shape[0]] = per_row[split_rows]
        fin_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                device)

        return SegmentPlan(
            seg_len=seg_len, seg_row=dev(row, np.int32),
            seg_start=dev(start, np.int64), seg_slot=dev(slot, np.int32),
            fin_row=dev(fin_row, np.int32), fin_ptr=dev(fin_ptr, np.int64),
            n_partials=int(fin_ptr[-1]))

    @property
    def n_segments(self) -> int:
        return int(self.seg_row.shape[0])


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """CSR adjacency on a torch device, as the SpMM kernel reads it, with
    its segment plan. ``from_csr`` builds the plan; a DeviceCSR made
    without one is refused by the SpMM.

    A row shard of a graph (``maxk_tpu_torch/parallel/partition.py``) is
    rectangular: ``n_nodes`` rows, and columns that index a table of
    ``n_cols`` rows which ``exchange`` builds from this rank's rows
    (``exchange.table(x)``: the halo exchange's ``[local | received]``
    rows, or the all-gather's global rows). Without an exchange the
    graph is square unless ``n_cols`` says otherwise.
    """

    indptr: torch.Tensor     # (V+1,) int64
    indices: torch.Tensor    # (E,)   int32
    values: torch.Tensor     # (E,)   float32
    n_nodes: int
    plan: Optional[SegmentPlan] = None
    n_cols: Optional[int] = None      # rows of the gathered operand
    exchange: Optional[object] = None  # parallel.halo.HaloSpec/GatherSpec

    def __post_init__(self):
        if self.n_cols is None:
            object.__setattr__(self, "n_cols", self.n_nodes)

    @staticmethod
    def from_csr(csr: CSRGraph, device=None, seg_len: int = SEG_LEN,
                 n_cols: Optional[int] = None,
                 exchange=None) -> "DeviceCSR":
        device = resolve_device(device)
        return DeviceCSR(
            indptr=torch.from_numpy(csr.indptr).to(device),
            indices=torch.from_numpy(csr.indices).to(device),
            values=torch.from_numpy(csr.values).to(device),
            n_nodes=csr.n_nodes,
            plan=SegmentPlan.build(csr, seg_len, device),
            n_cols=n_cols, exchange=exchange)

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indices.device
