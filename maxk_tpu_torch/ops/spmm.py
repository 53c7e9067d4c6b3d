"""SpMM: sparse CSR adjacency times dense features.

- ``spmm_dense_oracle``: densify A and matmul in float64 (tests only).
- ``spmm``: the production product on K2 (``ops/cuda_spmm.py``), with
  the JAX package's numerics: ``compute_dtype`` bfloat16 (the default for
  float32 x) rounds x to bfloat16, keeps the edge values in float32 and
  accumulates in float32; float32 runs x as is. The result is cast back
  to x's dtype.
- ``spmm_t``: ``spmm`` whose backward is K2 on the stored transpose,
  ``dx = A^T @ dy``, never autodiff through the gather.
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


def resolve_compute_dtype(compute_dtype: DTypeLike,
                          x_dtype: torch.dtype) -> torch.dtype:
    """None -> bfloat16 for float32 x, else x's dtype; names -> dtypes."""
    if compute_dtype is None:
        return torch.bfloat16 if x_dtype == torch.float32 else x_dtype
    if isinstance(compute_dtype, str):
        if compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} is not ported yet "
                f"(ROADMAP slice 3, item 10: opt-in compute modes)")
        return _DTYPES[compute_dtype]
    return compute_dtype


def spmm(g: DeviceCSR, x: torch.Tensor,
         compute_dtype: DTypeLike = None) -> torch.Tensor:
    """out[r] = sum_{e in row r} vals[e] * x[cols[e]], in x's dtype."""
    cd = resolve_compute_dtype(compute_dtype, x.dtype)
    return spmm_csr(g, x.to(cd).contiguous()).to(x.dtype)


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
