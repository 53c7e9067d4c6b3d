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

Not ported (ROADMAP item 10): the ``"int8_rowscale"`` compute mode, which
``resolve_compute_dtype`` refuses, and the CBSR-operand gather
formulation (``CBSR_GATHER_MODE``).
"""

from __future__ import annotations

import os

import torch

from maxk_tpu_torch.ops.cbsr import cbsr_expand, cbsr_gather, cbsr_topk
from maxk_tpu_torch.ops.cuda_topk import maxk_forward
from maxk_tpu_torch.ops.graph import DeviceCSR
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr
from maxk_tpu_torch.ops.spmm import (DTypeLike, gather_table,
                                     resolve_compute_dtype, spmm)

# The packed wire's widest row: its selectors are uint8.
WIRE_MAX_D = 256


def cbsr_route() -> bool:
    """True when MAXK_FUSED_MASK=0 selects the CBSR route."""
    return os.environ.get("MAXK_FUSED_MASK") == "0"


def uses_cbsr(g: DeviceCSR) -> bool:
    """True where maxk_spgemm runs on CBSR: under MAXK_FUSED_MASK=0, and
    on every row shard, where CBSR is the wire format."""
    return cbsr_route() or g.exchange is not None


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


def spgemm_forward_cbsr(g: DeviceCSR, values: torch.Tensor,
                        selector: torch.Tensor, dim: int,
                        compute_dtype: DTypeLike = None) -> torch.Tensor:
    """A @ expand(values, selector): node-level expansion, then K2. On a
    row shard the CBSR rows cross the wire first and the whole table is
    expanded."""
    if g.exchange is None:
        return spmm(g, cbsr_expand(values, selector, dim), compute_dtype)
    cd = resolve_compute_dtype(compute_dtype, values.dtype)
    table = gather_table(g, cbsr_wire(values, selector, dim, cd))
    v, s = cbsr_unwire(table, values.shape[1], dim, cd)
    x = cbsr_expand(v, s, dim).to(cd).contiguous()
    return spmm_csr(g, x).to(values.dtype)


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
        dx = cbsr_expand(sspmm_sampled(ctx.g_t, dy, selector, ctx.cd),
                         selector, ctx.dim)
        return dx.to(ctx.dtype), None, None, None, None


def maxk_spgemm(g: DeviceCSR, g_t: DeviceCSR, x: torch.Tensor, k: int,
                compute_dtype: DTypeLike = None) -> torch.Tensor:
    """Fused y = A @ MaxK_k(x), on the CBSR route under MAXK_FUSED_MASK=0
    or on a row shard, and on the mask route otherwise.

    g: adjacency (values encode the aggregation normalization); g_t: its
    transpose (g itself for a symmetric matrix); x: (V, D) float32;
    1 <= k <= D.
    """
    cd = resolve_compute_dtype(compute_dtype, x.dtype)
    fn = _MaxKSpgemmCBSR if uses_cbsr(g) else _MaxKSpgemm
    return fn.apply(x, g, g_t, k, cd)
