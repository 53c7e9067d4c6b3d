"""SpMM: sparse CSR adjacency times dense features.

- ``spmm_dense_oracle``: densify A and matmul in float64 (tests only).
- ``spmm_coo``: COO SpMM in torch ops, the benchmark harness's COO
  comparator (the role cuSPARSE's COO SpMM plays in the reference).
- ``spmm``: the production product on K2 (``ops/cuda_spmm.py``), with
  the JAX package's numerics: ``compute_dtype`` bfloat16 (the default for
  float32 x) rounds x to bfloat16, keeps the edge values in float32 and
  accumulates in float32; float32 runs x as is. The result is cast back
  to x's dtype.
- ``spmm_t``: ``spmm`` whose backward is K2 on the stored transpose,
  ``dx = A^T @ dy``, never autodiff through the gather.

On a row shard (a ``DeviceCSR`` with an ``exchange``,
``maxk_tpu_torch/parallel/``) ``spmm`` first exchanges x in the compute
dtype (the halo rows, or the all-gather) and runs K2 on the table, as
the JAX package's ``_spmm_halo`` does. ``spmm_t`` needs nothing more:
its backward is ``spmm`` on the sharded transpose, which exchanges dy.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from maxk_tpu_torch.ops.cuda_spmm import spmm_csr
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR

DTypeLike = Union[None, str, torch.dtype]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def spmm_dense_oracle(csr: CSRGraph, x: np.ndarray) -> np.ndarray:
    """Dense numpy oracle: A @ x. For tests only (O(V^2) memory)."""
    v = csr.n_nodes
    a = np.zeros((v, v), dtype=np.float64)
    rows, cols = csr.to_coo()
    np.add.at(a, (rows, cols), csr.values.astype(np.float64))
    return (a @ np.asarray(x, np.float64)).astype(np.float32)


# spmm_coo gathers at most this many (edge, feature) products at once, so
# it never holds E x D of them (13.4 GB at E = 13.1 M, D = 256, float32).
_COO_CHUNK_ELEMS = 1 << 26


def spmm_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """out[rows[e]] += vals[e] * x[cols[e]], in the promoted dtype of vals
    and x: ``index_add_`` of the products, chunked over edges. On CUDA
    ``index_add_`` adds with atomics, in no fixed order, so two calls may
    differ in the last bits of a row's sum."""
    out = torch.zeros((n_nodes, x.shape[1]),
                      dtype=torch.promote_types(vals.dtype, x.dtype),
                      device=x.device)
    step = max(1, _COO_CHUNK_ELEMS // max(1, x.shape[1]))
    for lo in range(0, rows.shape[0], step):
        hi = lo + step
        out.index_add_(0, rows[lo:hi], vals[lo:hi, None] * x[cols[lo:hi]])
    return out


def resolve_compute_dtype(compute_dtype: DTypeLike,
                          x_dtype: torch.dtype) -> torch.dtype:
    """None -> bfloat16 for float32 x, else x's dtype; names -> dtypes."""
    if compute_dtype is None:
        return torch.bfloat16 if x_dtype == torch.float32 else x_dtype
    if isinstance(compute_dtype, str):
        if compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} is not ported yet "
                f"(ROADMAP.md, queue 1: \"opt-in compute modes\")")
        return _DTYPES[compute_dtype]
    return compute_dtype


def gather_table(g: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """The rows g's columns index: x itself, or on a row shard the table
    its exchange builds from this rank's rows."""
    return x if g.exchange is None else g.exchange.table(x)


def spmm(g: DeviceCSR, x: torch.Tensor,
         compute_dtype: DTypeLike = None) -> torch.Tensor:
    """out[r] = sum_{e in row r} vals[e] * x[cols[e]], in x's dtype."""
    cd = resolve_compute_dtype(compute_dtype, x.dtype)
    return spmm_csr(g, gather_table(g, x.to(cd).contiguous())).to(x.dtype)


class _SpmmPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, g_t, cd):
        ctx.g_t, ctx.cd = g_t, cd
        return spmm(g, x, cd)

    @staticmethod
    def backward(ctx, dy):
        return spmm(ctx.g_t, dy, ctx.cd), None, None, None


def spmm_t(g: DeviceCSR, g_t: DeviceCSR, x: torch.Tensor,
           compute_dtype: DTypeLike = None) -> torch.Tensor:
    """spmm with an explicit-transpose backward: dx = A^T @ dy on g_t."""
    cd = resolve_compute_dtype(compute_dtype, x.dtype)
    return _SpmmPair.apply(x, g, g_t, cd)
