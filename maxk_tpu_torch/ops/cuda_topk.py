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

Both take any D. On a CUDA tensor each launches a hand-written kernel,
chosen by D: up to ``MAX_D`` = 1024 columns the register kernel,
``csrc/maxk_topk.cu`` or ``csrc/cbsr_topk.cu`` (one warp per row, the row
in registers, 32 values a lane at most); above it ``csrc/topk_wide.cu``
(``maxk_forward_wide``, ``cbsr_topk_forward_wide``: one block per row,
the row's keys in shared memory up to ``WIDE_SMEM_CAP``, streamed from
device memory above it, as ``wide_plan`` says), which computes the same
bits.
Every kernel stops its MSB-first threshold descent at the first step
whose count is exactly k (see the sources for the bound and design). On a
CPU tensor each op runs its plain version, the same descent in torch ops.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# The widest row of the register kernels (32 values a lane); wider rows go
# to the wide kernel.
MAX_D = 1024
# The wide kernel's block, the kThreads that csrc/topk_wide.cu is built
# with (reported by wide_plan, not passed), and the most bytes of a row's
# uint32 keys it holds in shared memory: 48 KB, D <= 12288 (the source's
# kSmemCap, above which its entries refuse the plan).
WIDE_THREADS = 128
WIDE_SMEM_CAP = 48 * 1024


class WidePlan(NamedTuple):
    """How csrc/topk_wide.cu takes rows of D columns, one a block:
    `smem_bytes` of dynamic shared memory for the row's keys, zero-padded
    to whole 16-byte quads, or 0 when the keys are read from device memory
    at every pass; `aligned` when D % 4 == 0, so that the rows of x and
    the outputs start on 16-byte boundaries wherever their bases do, and
    the wrapper asks for 16-byte loads and stores if the bases are."""
    smem_bytes: int
    aligned: bool

    @property
    def in_smem(self) -> bool:
        return self.smem_bytes != 0

    @property
    def threads(self) -> int:
        return WIDE_THREADS


def wide_plan(d: int) -> WidePlan:
    """The wide kernel's plan for rows of d columns."""
    return WidePlan(smem_bytes=16 * -(-d // 4) if 4 * d <= WIDE_SMEM_CAP
                    else 0, aligned=d % 4 == 0)


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
    """The full descent: 32 MSB-first steps to the largest t with
    count(key >= t) >= k, the k-th largest key of each row. The kernels
    stop earlier (`_threshold_early`) with the same keep set."""
    t = torch.zeros((key.shape[0], 1), dtype=torch.int64, device=key.device)
    for bit in range(31, -1, -1):
        cand = t | (1 << bit)
        cnt = (key >= cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt >= k, cand, t)
    return t


def _threshold_early(key: torch.Tensor, k: int):
    """The kernels' descent: (t (V, 1), steps (V,)). The same steps as
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
    keep = _keep_at(key, _threshold_early(key, k)[0], k)
    v = x.shape[0]
    selector = keep.nonzero()[:, 1].to(torch.int32).view(v, k)
    return x[keep].view(v, k), selector


@functools.cache
def _kernel(lib: str, entry: str, n_plan: int):
    """The C entry `entry` of csrc/`lib`.cu, which takes n_plan ints of a
    plan before the stream."""
    from maxk_tpu_torch.native.build import load
    fn = getattr(load(lib), entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   *[ctypes.c_int] * n_plan, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"maxk: need a 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"maxk: need 1 <= k <= D, got k={k}, "
                         f"D={x.shape[1]}")


def _launch(lib: str, entry: str, x: torch.Tensor, k: int,
            out_a: torch.Tensor, out_b: torch.Tensor, *plan: int) -> bool:
    """Run kernel `entry` of csrc/`lib`.cu on a CUDA x into out_a, out_b,
    with the ints of `plan` where the entry takes them; raises on what
    the kernels do not take and on a refused launch. False if V = 0 left
    nothing to launch."""
    if x.device.type != "cuda":
        raise ValueError(f"maxk: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("maxk kernel: x must be contiguous")
    v, d = x.shape
    if v == 0:
        return False
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(lib, entry, len(plan))(
            x.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), v, d, k,
            *plan, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return True


def _maxk_out(x: torch.Tensor):
    return (torch.empty_like(x),
            torch.empty(x.shape, dtype=torch.uint8, device=x.device))


def _cbsr_out(x: torch.Tensor, k: int):
    v = x.shape[0]
    return (torch.empty((v, k), dtype=torch.float32, device=x.device),
            torch.empty((v, k), dtype=torch.int32, device=x.device))


def maxk_forward(x: torch.Tensor, k: int):
    """(y, mask) for a (V, D) float32 x; on CUDA tensors K1, or the wide
    kernel for D > MAX_D."""
    _check(x, k)
    if x.device.type == "cpu":
        return maxk_forward_plain(x, k)
    if x.shape[1] > MAX_D:
        return maxk_forward_wide(x, k)
    y, mask = _maxk_out(x)
    if _launch("maxk_topk", "maxk_topk_f32", x, k, y, mask):
        maxk_forward.launches += 1
    return y, mask


def cbsr_topk_forward(x: torch.Tensor, k: int):
    """(values, selector) for a (V, D) float32 x; on CUDA tensors K4, or
    the wide kernel for D > MAX_D."""
    _check(x, k)
    if x.device.type == "cpu":
        return cbsr_topk_plain(x, k)
    if x.shape[1] > MAX_D:
        return cbsr_topk_forward_wide(x, k)
    values, selector = _cbsr_out(x, k)
    if _launch("cbsr_topk", "cbsr_topk_f32", x, k, values, selector):
        cbsr_topk_forward.launches += 1
    return values, selector


def _launch_wide(op, entry: str, x: torch.Tensor, k: int,
                 out_a: torch.Tensor, out_b: torch.Tensor) -> None:
    """Launch `entry` of csrc/topk_wide.cu on wide_plan(D), counted on op:
    `launches`, and `streamed` for those that read the row from device
    memory at every pass."""
    plan = wide_plan(x.shape[1])
    vec = plan.aligned and all(t.data_ptr() % 16 == 0
                               for t in (x, out_a, out_b))
    if _launch("topk_wide", entry, x, k, out_a, out_b, int(vec),
               plan.smem_bytes):
        op.launches += 1
        op.streamed += not plan.in_smem


def maxk_forward_wide(x: torch.Tensor, k: int):
    """`maxk_forward` through csrc/topk_wide.cu at any D on CUDA tensors
    (`maxk_forward` sends it rows wider than MAX_D)."""
    _check(x, k)
    if x.device.type == "cpu":
        return maxk_forward_plain(x, k)
    y, mask = _maxk_out(x)
    _launch_wide(maxk_forward_wide, "maxk_wide_f32", x, k, y, mask)
    return y, mask


def cbsr_topk_forward_wide(x: torch.Tensor, k: int):
    """`cbsr_topk_forward` through csrc/topk_wide.cu at any D on CUDA
    tensors (`cbsr_topk_forward` sends it rows wider than MAX_D)."""
    _check(x, k)
    if x.device.type == "cpu":
        return cbsr_topk_plain(x, k)
    values, selector = _cbsr_out(x, k)
    _launch_wide(cbsr_topk_forward_wide, "cbsr_topk_wide_f32", x, k, values,
                 selector)
    return values, selector


maxk_forward.launches = 0
cbsr_topk_forward.launches = 0
maxk_forward_wide.launches = 0
cbsr_topk_forward_wide.launches = 0
maxk_forward_wide.streamed = 0
cbsr_topk_forward_wide.streamed = 0
