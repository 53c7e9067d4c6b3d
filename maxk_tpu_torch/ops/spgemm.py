"""Fused MaxK SpGEMM: y = A @ MaxK_k(x), on the mask or the CBSR route.

Mask route (the default):
forward:  y_s, mask = MaxK(x, k)        # K1, ops/cuda_topk.py
          y         = A @ y_s           # K2, ops/cuda_spmm.py
backward: dx        = mask * (A^T @ dy) # K2 on the stored transpose

CBSR route (``MAXK_FUSED_MASK=0``, read at call time, as the JAX package
reads it at trace time):
forward:  (v, s) = cbsr_topk(x, k)      # K4
          y      = A @ expand(v, s)     # K2
backward: g      = sspmm_sampled(A^T, dy, s)
                 = (A^T @ dy)[i, s[i, l]]  # K2, then K3 (ops/cbsr.py)
          dx     = expand(g, s)

Halo route (any row shard, ``DeviceCSR.exchange`` set: CBSR is the wire
format there, whatever MAXK_FUSED_MASK says, as in the JAX package's
``_mask_path``):
forward:  (v, s) = cbsr_topk(x_local, k)           # K4, local rows
          table  = exchange(wire(v, s))            # one all_to_all
          y      = A_shard @ expand(unwire(table)) # K2 on the table
backward: the CBSR route's, on the sharded transpose: its spmm
          exchanges dy (dense, in the compute dtype) before K2, then K3

The wire is bfloat16 values and uint8 selectors, 3k bytes a row, under
bfloat16 compute at D <= 256 (the bytes of the JAX package's bf16-pair
and uint8-quad packing); else float32 values and int32 selectors. Both
round to what K2 reads anyway, so a shard's rows are bit-equal to the
single-device CBSR route's.

The two are the same function: expand(cbsr_topk(x)) == MaxK(x) and
expand(gather(dS, s), s) == mask * dS. Under bfloat16 compute the CBSR
backward hands dS to the sampler in bfloat16, as the JAX package does,
so its dx is the mask route's dx rounded to bfloat16. It comes back in
x's dtype: the JAX package returns a bfloat16 cotangent there.

CBSR-operand forward (``CBSR_GATHER_MODE = True``, a module attribute
read at call time, as the JAX package reads its own at trace time): the
CBSR route everywhere (``uses_cbsr``), with K5 (``ops/cuda_spgemm_cbsr.py``)
in place of the expansion and K2 in the forward where the JAX package's
gate holds (dim <= 256, 1 <= k <= 128): on one device, and on a shard in
the all-gather mode, where K5 reads the received table. It reads k values
(in the compute dtype) and k uint8 selectors per edge, and its sums are
K2's on the expanded operand, bit for bit up to the sign of a zero.
Outside the gate, and in halo mode, the expansion runs, as in the JAX
package. The backward is the CBSR route's.

The opt-in compute modes, as the JAX package dispatches them
(``spgemm_forward_cbsr``):
- ``"int8"``: every ``spmm`` quantizes its operand per column and runs
  K7 (``ops/spmm.py``), on the mask route and in the CBSR route's
  expansion and backward; never K5. On a halo shard the CBSR forward
  computes in bfloat16.
- ``"int8_rowscale"`` (``spgemm_forward_cbsr`` and ``maxk_spgemm``
  only; it sends ``maxk_spgemm`` to the CBSR route): at dim % 4 == 0 K6's
  int8 mode writes the expansion as an int8 table with a per-row scale
  and K7 reads it; else, and in halo mode, bfloat16. Its backward
  computes in bfloat16.
- Hub columns (``DeviceCSR.hub_ids``): where the forward reads CBSR rows
  (K5, the row-scaled table) the hub rows are expanded (K6) and their
  term, ``hub_matmul``, added; the expansion route's ``spmm`` adds it
  itself.
"""

from __future__ import annotations

import os

import torch

from maxk_tpu_torch.ops.cbsr import (cbsr_expand, cbsr_expand_int8,
                                     cbsr_gather, cbsr_topk)
from maxk_tpu_torch.ops.cuda_spgemm_cbsr import MAX_DIM, MAX_K, spgemm_cbsr_csr
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_csr
from maxk_tpu_torch.ops.cuda_topk import maxk_forward
from maxk_tpu_torch.ops.graph import DeviceCSR
from maxk_tpu_torch.ops.spmm import (INT8, INT8_ROWSCALE, DTypeLike,
                                     gather_table, hub_matmul,
                                     resolve_compute_dtype, spmm,
                                     spmm_table)

# The packed wire's widest row: its selectors are uint8.
WIRE_MAX_D = 256

# Opt-in: the forward reads CBSR rows per edge (K5), as the JAX package's
# CBSR_GATHER_MODE does. Off by default; read at call time.
CBSR_GATHER_MODE = False


def cbsr_route() -> bool:
    """True when MAXK_FUSED_MASK=0 selects the CBSR route."""
    return os.environ.get("MAXK_FUSED_MASK") == "0"


def uses_cbsr(g: DeviceCSR, compute_dtype: DTypeLike = None) -> bool:
    """True where maxk_spgemm runs on CBSR: under MAXK_FUSED_MASK=0 or
    CBSR_GATHER_MODE, on every row shard, where CBSR is the wire format,
    and under "int8_rowscale" (the JAX package's ``_mask_path``)."""
    return (cbsr_route() or CBSR_GATHER_MODE or g.exchange is not None
            or compute_dtype == INT8_ROWSCALE)


def _gather_gate(dim: int, k: int, cd) -> bool:
    """The JAX package's gate of the CBSR-operand forward: never under
    the int8 modes."""
    return (CBSR_GATHER_MODE and dim <= MAX_DIM and 1 <= k <= MAX_K
            and cd not in (INT8, INT8_ROWSCALE))


def _wire_dtypes(dim: int, cd: torch.dtype):
    """(values, selector) dtypes on the wire: bf16 and uint8 (3k bytes a
    row) under bf16 compute at dim <= 256, else float32 and int32."""
    if cd == torch.bfloat16 and dim <= WIRE_MAX_D:
        return torch.bfloat16, torch.uint8
    return torch.float32, torch.int32


def cbsr_wire(values: torch.Tensor, selector: torch.Tensor, dim: int,
              cd: torch.dtype) -> torch.Tensor:
    """CBSR rows as one (V, bytes) uint8 wire, values then selectors."""
    vt, st = _wire_dtypes(dim, cd)
    return torch.cat([values.to(vt).contiguous().view(torch.uint8),
                      selector.to(st).contiguous().view(torch.uint8)], 1)


def cbsr_unwire(wire: torch.Tensor, k: int, dim: int,
                cd: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, selector) of cbsr_wire's rows."""
    vt, st = _wire_dtypes(dim, cd)
    vb = k * vt.itemsize
    return (wire[:, :vb].contiguous().view(vt),
            wire[:, vb:].contiguous().view(st))


def _spgemm_cbsr_gather(g: DeviceCSR, values: torch.Tensor,
                        selector: torch.Tensor, dim: int,
                        cd: torch.dtype) -> torch.Tensor:
    """K5 on the (values in cd, uint8 selectors) table."""
    return spgemm_cbsr_csr(g, values.to(cd).contiguous(),
                           selector.to(torch.uint8).contiguous(), dim)


def _hub_term_cbsr(g: DeviceCSR, values: torch.Tensor,
                   selector: torch.Tensor, dim: int, cd) -> torch.Tensor:
    """The hub columns' term where the forward reads CBSR rows: only the
    H hub rows are expanded (K6), then the slab matmul."""
    ids = g.hub_ids.long()
    return hub_matmul(g.hub_dense,
                      cbsr_expand(values[ids].contiguous(),
                                  selector[ids].contiguous(), dim), cd)


def _forward_on_table(g: DeviceCSR, values: torch.Tensor,
                      selector: torch.Tensor, dim: int, cd) -> torch.Tensor:
    """float32 A @ expand(values, selector) for CBSR rows that g's columns
    index (one device, or the all-gathered table), dispatched as the JAX
    package's ``spgemm_forward_cbsr``: the row-scaled int8 table (K6's
    int8 mode, K7), K5 under its gate, else the expansion (K6) and
    ``spmm_table`` (K2, or K7 under "int8")."""
    hub = None
    if cd == INT8_ROWSCALE and dim % 4 == 0:
        out = spmm_int8_csr(g, *cbsr_expand_int8(values, selector, dim),
                            row_scale=True)
        hub = torch.bfloat16
    elif _gather_gate(dim, values.shape[1], cd):
        out = _spgemm_cbsr_gather(g, values, selector, dim, cd)
        hub = cd
    else:
        if cd == INT8_ROWSCALE:
            cd = torch.bfloat16
        x = cbsr_expand(values, selector, dim,
                        torch.float32 if cd == INT8 else cd)
        return spmm_table(g, x, cd)
    if g.hub_ids is not None:
        out = out + _hub_term_cbsr(g, values, selector, dim, hub)
    return out


def spgemm_forward_cbsr(g: DeviceCSR, values: torch.Tensor,
                        selector: torch.Tensor, dim: int,
                        compute_dtype: DTypeLike = None) -> torch.Tensor:
    """A @ expand(values, selector), in values' dtype: K5 on the CBSR rows
    under CBSR_GATHER_MODE's gate, the row-scaled int8 table under
    "int8_rowscale", else node-level expansion, then K2 (K7 under "int8").
    On a row shard the CBSR rows cross the wire first; in halo mode the
    whole table is expanded and the int8 modes compute in bfloat16."""
    cd = resolve_compute_dtype(compute_dtype, values.dtype)
    if g.exchange is None:
        return _forward_on_table(g, values, selector, dim,
                                 cd).to(values.dtype)
    whole = getattr(g.exchange, "whole_table", False)
    if not whole and cd in (INT8, INT8_ROWSCALE):
        cd = torch.bfloat16
    table = gather_table(g, cbsr_wire(values, selector, dim, cd))
    v, s = cbsr_unwire(table, values.shape[1], dim, cd)
    if whole:
        return _forward_on_table(g, v, s, dim, cd).to(values.dtype)
    return spmm_table(g, cbsr_expand(v, s, dim, cd), cd).to(values.dtype)


def sspmm_sampled(g_t: DeviceCSR, dy: torch.Tensor, selector: torch.Tensor,
                  compute_dtype: DTypeLike = None) -> torch.Tensor:
    """The backward SSpMM, (V, k): g[i, l] = (A^T @ dy)[i, selector[i, l]].

    A^T @ dy runs on K2; unless the compute dtype is float32 it is handed
    to the sampler (K3) in bfloat16, so the result is bfloat16 then.
    """
    cd = resolve_compute_dtype(compute_dtype, dy.dtype)
    ds = spmm(g_t, dy, cd)
    if cd != torch.float32:
        ds = ds.to(torch.bfloat16)
    return cbsr_gather(ds, selector)


class _MaxKSpgemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, g_t, k, cd):
        y_s, mask = maxk_forward(x, k)
        ctx.save_for_backward(mask)
        ctx.g_t, ctx.cd = g_t, cd
        return spmm(g, y_s, cd)

    @staticmethod
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        return spmm(ctx.g_t, dy, ctx.cd) * mask, None, None, None, None


class _MaxKSpgemmCBSR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, g_t, k, cd):
        values, selector = cbsr_topk(x, k)
        ctx.save_for_backward(selector)
        ctx.g_t, ctx.cd, ctx.dim, ctx.dtype = g_t, cd, x.shape[1], x.dtype
        return spgemm_forward_cbsr(g, values, selector, x.shape[1], cd)

    @staticmethod
    def backward(ctx, dy):
        (selector,) = ctx.saved_tensors
        dx = cbsr_expand(
            sspmm_sampled(ctx.g_t, dy, selector, _backward_cd(ctx.cd)),
            selector, ctx.dim, ctx.dtype)
        return dx, None, None, None, None


def _backward_cd(cd):
    """The backward's compute dtype (the JAX package's ``_resolve_cd``):
    bfloat16 under "int8_rowscale", whose row scale does not apply to the
    dense gradient rows; every other mode its own."""
    return torch.bfloat16 if cd == INT8_ROWSCALE else cd


def maxk_spgemm(g: DeviceCSR, g_t: DeviceCSR, x: torch.Tensor, k: int,
                compute_dtype: DTypeLike = None) -> torch.Tensor:
    """Fused y = A @ MaxK_k(x), on the CBSR route under MAXK_FUSED_MASK=0
    or CBSR_GATHER_MODE or on a row shard, and on the mask route
    otherwise.

    g: adjacency (values encode the aggregation normalization); g_t: its
    transpose (g itself for a symmetric matrix); x: (V, D) float32;
    1 <= k <= D.
    """
    cd = resolve_compute_dtype(compute_dtype, x.dtype)
    fn = _MaxKSpgemmCBSR if uses_cbsr(g, cd) else _MaxKSpgemm
    return fn.apply(x, g, g_t, k, cd)
