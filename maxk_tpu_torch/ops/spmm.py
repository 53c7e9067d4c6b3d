"""SpMM: sparse CSR adjacency times dense features.

- ``spmm_dense_oracle``: densify A and matmul in float64 (tests only).
- ``spmm_coo``: COO SpMM in torch ops, the benchmark harness's COO
  comparator (the role cuSPARSE's COO SpMM plays in the reference).
- ``spmm``: the production product on K2 (``ops/cuda_spmm.py``), with
  the JAX package's numerics: ``compute_dtype`` bfloat16 (the default for
  float32 x) rounds x to bfloat16, keeps the edge values in float32 and
  accumulates in float32; float32 runs x as is. The result is cast back
  to x's dtype.
  ``compute_dtype="int8"`` (opt-in, the JAX package's quantized gather)
  quantizes x per column (``quantize_columns``) and runs K7
  (``ops/cuda_spmm_int8.py``) on the int8 table, scaling each output
  column; at D % 4 != 0 it computes in bfloat16, as the JAX package does.
- ``spmm_t``: ``spmm`` whose backward is K2 on the stored transpose,
  ``dx = A^T @ dy``, never autodiff through the gather.

On a row shard (a ``DeviceCSR`` with an ``exchange``,
``maxk_tpu_torch/parallel/``) ``spmm`` first exchanges x in the compute
dtype (the halo rows, or the all-gather) and runs K2 on the table, as
the JAX package's ``_spmm_halo`` does; under "int8" it exchanges x as it
is and quantizes the table. ``spmm_t`` needs nothing more: its backward
is ``spmm`` on the sharded transpose, which exchanges dy.

On a graph with a hub split (``DeviceCSR.from_csr(..., hub_cols=...)``)
the residual edges run on the kernel and the hub columns add
``hub_matmul(hub_dense, x[hub_ids])``; shards refuse hubs (TypeError).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from maxk_tpu_torch.ops.cuda_spgemm_cbsr import fma_f32
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_csr
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR

DTypeLike = Union[None, str, torch.dtype]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The opt-in quantized modes, carried by name.
INT8 = "int8"
INT8_ROWSCALE = "int8_rowscale"
# The column scale's float32 constants: XLA computes max / 127 + 1e-12 as
# fma(max, float32(1 / 127), 1e-12).
_INV_127 = 1.0 / 127.0
_COL_EPS = 1e-12


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


def resolve_compute_dtype(compute_dtype: DTypeLike, x_dtype: torch.dtype):
    """None -> bfloat16 for float32 x, else x's dtype; names -> dtypes.
    The quantized modes stay names, as the JAX package's ``_dtype_name``
    keeps them: "int8" (``torch.int8`` too) and "int8_rowscale"."""
    if compute_dtype is None:
        return torch.bfloat16 if x_dtype == torch.float32 else x_dtype
    if compute_dtype == torch.int8:
        return INT8
    if isinstance(compute_dtype, str):
        if compute_dtype in (INT8, INT8_ROWSCALE):
            return compute_dtype
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        return _DTYPES[compute_dtype]
    return compute_dtype


def gather_table(g: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """The rows g's columns index: x itself, or on a row shard the table
    its exchange builds from this rank's rows."""
    return x if g.exchange is None else g.exchange.table(x)


def quantize_columns(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The "int8" mode's table of a float32 x: (q (V, D) int8, scale (D,)
    float32) with scale = max_rows |x| / 127 + 1e-12 (as XLA computes it,
    one float32 fma) and q = clamp(round(x / scale), -127, 127), rounding
    half to even; bit-equal to the JAX package's ``_pack_x`` unpacked."""
    x = x.float()
    # max |x| from one read of x: max(max x, -min x), exactly.
    lo, hi = torch.aminmax(x, dim=0)
    amax = torch.maximum(hi, -lo)
    scale = fma_f32(amax, torch.full_like(amax, _INV_127),
                    torch.full_like(amax, _COL_EPS))
    # In place after the division: one float32 temporary, not three.
    q = (x / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def hub_matmul(hub_dense: torch.Tensor, x_rows: torch.Tensor,
               compute_dtype) -> torch.Tensor:
    """The hub columns' term, hub_dense @ x_rows, in float32: full float32
    under float32 compute; under every other mode of bfloat16-rounded
    operands with a float32 result, as the JAX package's
    ``preferred_element_type=float32`` product (TF32 must be off, torch's
    default)."""
    if compute_dtype == torch.float32:
        return torch.matmul(hub_dense, x_rows.float())
    return torch.matmul(hub_dense.to(torch.bfloat16).float(),
                        x_rows.to(torch.bfloat16).float())


def spmm_table(g: DeviceCSR, table: torch.Tensor, cd) -> torch.Tensor:
    """float32 A @ table for a table of the rows g's columns index (no
    exchange), under a resolved compute dtype other than "int8_rowscale":
    under "int8" at D % 4 == 0 the quantized table on K7, else K2 on the
    table in the compute dtype ("int8" at other D computes in bfloat16, as
    the JAX package's ``_pack_x``); then the hub term."""
    if cd == INT8 and table.shape[1] % 4 == 0:
        out = spmm_int8_csr(g, *quantize_columns(table), row_scale=False)
    else:
        out = spmm_csr(g, table.to(float_dtype(cd)).contiguous())
    if g.hub_ids is not None:
        out = out + hub_matmul(g.hub_dense, table[g.hub_ids.long()], cd)
    return out


def float_dtype(compute_dtype) -> torch.dtype:
    """The float dtype K2 computes in: bfloat16 for the int8 modes."""
    return (torch.bfloat16 if compute_dtype in (INT8, INT8_ROWSCALE)
            else compute_dtype)


def spmm(g: DeviceCSR, x: torch.Tensor,
         compute_dtype: DTypeLike = None) -> torch.Tensor:
    """out[r] = sum_{e in row r} vals[e] * x[cols[e]], in x's dtype. On a
    row shard x's rows are exchanged first: cast to the compute dtype, or
    under "int8" as they are, so that the scale covers the received rows
    too (the JAX package's ``_spmm_halo``)."""
    cd, out_dtype = resolve_compute_dtype(compute_dtype, x.dtype), x.dtype
    if cd == INT8_ROWSCALE:
        raise TypeError("int8_rowscale is a mode of the CBSR forward "
                        "(spgemm_forward_cbsr, maxk_spgemm), not of spmm")
    if g.hub_ids is not None and g.exchange is not None:
        raise TypeError("hub-densified graphs are single-device only; "
                        "build row shards with hub_cols=0 (the slab term "
                        "would be dropped)")
    if cd != INT8 or x.shape[1] % 4:
        x = x.to(float_dtype(cd)).contiguous()
    return spmm_table(g, gather_table(g, x), cd).to(out_dtype)


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
