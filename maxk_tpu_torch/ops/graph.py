"""Graph containers: host-side numpy CSR and the device-side DeviceCSR.

``CSRGraph`` is a numpy copy of the JAX package's host CSR (same
constructors, transforms and normalizations, bit-equal outputs). The
device form is plain CSR arrays on a torch device: the SpMM kernel
(``csrc/spmm_csr.cu``) walks rows of the CSR directly, so the TPU's
row-block edge tiles have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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
class DeviceCSR:
    """CSR adjacency on a torch device, as the SpMM kernel reads it."""

    indptr: torch.Tensor     # (V+1,) int64
    indices: torch.Tensor    # (E,)   int32
    values: torch.Tensor     # (E,)   float32
    n_nodes: int

    @staticmethod
    def from_csr(csr: CSRGraph, device=None) -> "DeviceCSR":
        device = resolve_device(device)
        return DeviceCSR(
            indptr=torch.from_numpy(csr.indptr).to(device),
            indices=torch.from_numpy(csr.indices).to(device),
            values=torch.from_numpy(csr.values).to(device),
            n_nodes=csr.n_nodes)

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indices.device
