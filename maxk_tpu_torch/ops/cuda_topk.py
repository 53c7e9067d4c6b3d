"""K1: exact per-row MaxK, as a CUDA kernel and its plain PyTorch version.

``maxk_forward(x, k)`` returns ``(y, mask)``: ``y = x * mask`` and a 0/1
uint8 mask of each row's k largest entries, ties at the threshold kept
first-column-first. It replaces the TPU kernel
``maxk_tpu/ops/pallas_topk.py::_maxk_kernel`` and computes the same bits.

On a CUDA tensor it launches ``csrc/maxk_topk.cu`` (one warp per row,
32-step threshold descent in registers; see the source for its bound and
design). On a CPU tensor it runs ``maxk_forward_plain``, the same
descent in torch ops. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_D = 1024   # the kernel keeps a row in registers: 32 values per lane


def sortable_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 key in [0, 2**32), order-isomorphic to x.

    The uint32 key of the TPU kernel (negative: ~bits, else
    bits | 2**31), built from the int32 view with the signed flip
    ``bits ^ ((bits >> 31) & 0x7FFFFFFF)`` (which orders -0.0 below
    +0.0) and shifted by 2**31 into int64, since torch has little uint32
    arithmetic.
    """
    bits = x.contiguous().view(torch.int32)
    signed = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return signed.to(torch.int64) + (1 << 31)


def maxk_forward_plain(x: torch.Tensor, k: int):
    """The kernel's algorithm in torch ops: (y, uint8 mask)."""
    key = sortable_key(x)
    t = torch.zeros((x.shape[0], 1), dtype=torch.int64, device=x.device)
    for bit in range(31, -1, -1):
        cand = t | (1 << bit)
        cnt = (key >= cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt >= k, cand, t)
    gt = key > t
    tie = key == t
    need = k - gt.sum(dim=1, keepdim=True)
    keep = gt | (tie & (torch.cumsum(tie, dim=1) <= need))
    # +0.0 where dropped, as the TPU kernel's y (see maxk_topk.cu).
    return torch.where(keep, x, 0.0), keep.to(torch.uint8)


@functools.cache
def _kernel():
    from maxk_tpu_torch.native.build import load
    fn = load("maxk_topk").maxk_topk_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"maxk: need a 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"maxk: need 1 <= k <= D, got k={k}, "
                         f"D={x.shape[1]}")


def maxk_forward(x: torch.Tensor, k: int):
    """(y, mask) for a (V, D) float32 x; the kernel on CUDA tensors."""
    _check(x, k)
    if x.device.type == "cpu":
        return maxk_forward_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"maxk: unsupported device {x.device}")
    v, d = x.shape
    if d > MAX_D:
        raise ValueError(f"maxk kernel: D={d} > {MAX_D} is not supported "
                         f"yet (ROADMAP: K1 for D > 1024)")
    if not x.is_contiguous():
        raise ValueError("maxk kernel: x must be contiguous")
    y = torch.empty_like(x)
    mask = torch.empty((v, d), dtype=torch.uint8, device=x.device)
    if v == 0:
        return y, mask
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), y.data_ptr(), mask.data_ptr(), v, d,
                        k, stream)
    if err != 0:
        raise RuntimeError(f"maxk_topk kernel launch failed: CUDA error "
                           f"{err}")
    maxk_forward.launches += 1
    return y, mask


maxk_forward.launches = 0
