"""K1 and K4: exact per-row top-k, as CUDA kernels and their plain
PyTorch versions.

``maxk_forward(x, k)`` (K1) returns ``(y, mask)``: ``y = x * mask`` and a
0/1 uint8 mask of each row's k largest entries, ties at the threshold
kept first-column-first. It replaces the TPU kernel
``maxk_tpu/ops/pallas_topk.py::_maxk_kernel`` and computes the same bits.

``cbsr_topk_forward(x, k)`` (K4) keeps the same k entries and returns
them compacted as CBSR: ``(values, selector)``, float32 and int32 of
shape (V, k), selectors ascending per row. It replaces
``pallas_topk.py::_cbsr_kernel`` and ``::_cbsr_half_kernel``.

On a CUDA tensor each launches its kernel, ``csrc/maxk_topk.cu`` and
``csrc/cbsr_topk.cu`` (one warp per row, MSB-first threshold descent in
registers; see the sources for the bound and design). K1's descent stops
at the first step whose count is exactly k; K4's runs all 32 steps. On a
CPU tensor each runs its plain version, the same descent in torch ops.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_D = 1024   # the kernels keep a row in registers: 32 values per lane


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


def _keep_at(key: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """The kernels' bool keep-mask at threshold t (V, 1): every key > t,
    then the first k - count(key > t) keys equal to t in column order."""
    gt = key > t
    tie = key == t
    need = k - gt.sum(dim=1, keepdim=True)
    return gt | (tie & (torch.cumsum(tie, dim=1) <= need))


def _threshold_full(key: torch.Tensor, k: int) -> torch.Tensor:
    """K4's descent: 32 MSB-first steps to the largest t with
    count(key >= t) >= k, the k-th largest key of each row."""
    t = torch.zeros((key.shape[0], 1), dtype=torch.int64, device=key.device)
    for bit in range(31, -1, -1):
        cand = t | (1 << bit)
        cnt = (key >= cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt >= k, cand, t)
    return t


def _threshold_early(key: torch.Tensor, k: int):
    """K1's descent: (t (V, 1), steps (V,)). The same steps as
    `_threshold_full`, but a row's t stops changing once
    cnt_t = count(key >= t) is k (cnt_t starts at D). The k keys >= t are
    then the row's top k, so `_keep_at` gives the full descent's mask.
    `steps` counts the steps each row ran: 32 - floor(log2(key_k ^
    key_k+1)) of its k-th and (k+1)-th largest keys, 32 if they are
    equal, 0 if k = D."""
    v, d = key.shape
    t = torch.zeros((v, 1), dtype=torch.int64, device=key.device)
    cnt_t = torch.full((v, 1), d, dtype=torch.int64, device=key.device)
    steps = torch.zeros((v, 1), dtype=torch.int64, device=key.device)
    for bit in range(31, -1, -1):
        live = cnt_t != k
        if not bool(live.any()):
            break
        cand = t | (1 << bit)
        cnt = (key >= cand).sum(dim=1, keepdim=True)
        take = live & (cnt >= k)
        t = torch.where(take, cand, t)
        cnt_t = torch.where(take, cnt, cnt_t)
        steps += live
    return t, steps[:, 0]


def maxk_forward_plain(x: torch.Tensor, k: int):
    """K1's algorithm in torch ops: (y, uint8 mask)."""
    key = sortable_key(x)
    keep = _keep_at(key, _threshold_early(key, k)[0], k)
    # +0.0 where dropped, as the TPU kernel's y (see maxk_topk.cu).
    return torch.where(keep, x, 0.0), keep.to(torch.uint8)


def cbsr_topk_plain(x: torch.Tensor, k: int):
    """K4's algorithm in torch ops: (values, int32 selector). Each row
    keeps exactly k columns, so the row-major order of the keep-mask's
    nonzeros gives each row's selectors ascending."""
    key = sortable_key(x)
    keep = _keep_at(key, _threshold_full(key, k), k)
    v = x.shape[0]
    selector = keep.nonzero()[:, 1].to(torch.int32).view(v, k)
    return x[keep].view(v, k), selector


@functools.cache
def _kernel(name: str):
    """The C entry `name`_f32 of csrc/`name`.cu."""
    from maxk_tpu_torch.native.build import load
    fn = getattr(load(name), f"{name}_f32")
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


def _launch(name: str, x: torch.Tensor, k: int, out_a: torch.Tensor,
            out_b: torch.Tensor) -> bool:
    """Run kernel `name` (maxk_topk or cbsr_topk) on a CUDA x into out_a,
    out_b; raises on what the kernels do not take. False if V = 0 left
    nothing to launch."""
    if x.device.type != "cuda":
        raise ValueError(f"maxk: unsupported device {x.device}")
    v, d = x.shape
    if d > MAX_D:
        raise ValueError(f"maxk kernel: D={d} > {MAX_D} is not supported "
                         f"yet (ROADMAP: K1 for D > 1024)")
    if not x.is_contiguous():
        raise ValueError("maxk kernel: x must be contiguous")
    if v == 0:
        return False
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(x.data_ptr(), out_a.data_ptr(),
                            out_b.data_ptr(), v, d, k, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return True


def maxk_forward(x: torch.Tensor, k: int):
    """(y, mask) for a (V, D) float32 x; K1 on CUDA tensors."""
    _check(x, k)
    if x.device.type == "cpu":
        return maxk_forward_plain(x, k)
    y = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if _launch("maxk_topk", x, k, y, mask):
        maxk_forward.launches += 1
    return y, mask


def cbsr_topk_forward(x: torch.Tensor, k: int):
    """(values, selector) for a (V, D) float32 x; K4 on CUDA tensors."""
    _check(x, k)
    if x.device.type == "cpu":
        return cbsr_topk_plain(x, k)
    v = x.shape[0]
    values = torch.empty((v, k), dtype=torch.float32, device=x.device)
    selector = torch.empty((v, k), dtype=torch.int32, device=x.device)
    if _launch("cbsr_topk", x, k, values, selector):
        cbsr_topk_forward.launches += 1
    return values, selector


maxk_forward.launches = 0
cbsr_topk_forward.launches = 0
