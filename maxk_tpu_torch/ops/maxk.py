"""MaxK nonlinearity: keep each row's top-k channels, zero the rest.

Forward ``x * mask`` and backward ``g * mask`` (straight-through on the
kept positions), with the mask from K1 (``ops/cuda_topk.py``): exact
float32 threshold, ties kept first-column-first, any 1 <= k <= D.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops.cuda_topk import maxk_forward


def maxk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask of each row's top-k entries, in x's dtype."""
    return maxk_forward(x, k)[1].to(x.dtype)


class _MaxK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        y, mask = maxk_forward(x, k)
        ctx.save_for_backward(mask)
        return y

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None


def maxk(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxK(x) = x * topk_mask(x). Rows of x are nodes, columns channels."""
    return _MaxK.apply(x, k)
