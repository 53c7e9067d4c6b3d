"""Fused MaxK SpGEMM: y = A @ MaxK_k(x), single-device mask route.

forward:  y_s, mask = MaxK(x, k)        # K1, ops/cuda_topk.py
          y         = A @ y_s           # K2, ops/cuda_spmm.py
backward: dx        = mask * (A^T @ dy) # K2 on the stored transpose

The JAX package also has a CBSR route (top-k values + selectors, sampled
backward) for its distributed halo exchange and opt-in formulations. It
is not ported yet: ROADMAP slice 3.
"""

from __future__ import annotations

import os

import torch

from maxk_tpu_torch.ops.cuda_topk import maxk_forward
from maxk_tpu_torch.ops.graph import DeviceCSR
from maxk_tpu_torch.ops.spmm import DTypeLike, resolve_compute_dtype, spmm


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


def maxk_spgemm(g: DeviceCSR, g_t: DeviceCSR, x: torch.Tensor, k: int,
                compute_dtype: DTypeLike = None) -> torch.Tensor:
    """Fused y = A @ MaxK_k(x) with the mask-route backward.

    g: adjacency (values encode the aggregation normalization); g_t: its
    transpose (g itself for a symmetric matrix); x: (V, D) float32;
    1 <= k <= D.
    """
    if os.environ.get("MAXK_FUSED_MASK") == "0":
        raise NotImplementedError(
            "the CBSR route of maxk_spgemm (MAXK_FUSED_MASK=0) is not "
            "ported yet: ROADMAP slice 3")
    cd = resolve_compute_dtype(compute_dtype, x.dtype)
    return _MaxKSpgemm.apply(x, g, g_t, k, cd)
