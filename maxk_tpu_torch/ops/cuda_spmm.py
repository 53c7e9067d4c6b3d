"""K2: CSR SpMM, as a CUDA kernel and its plain PyTorch version.

``spmm_csr(g, x)`` returns the float32 ``(V, D)`` product ``A @ x`` of a
``DeviceCSR`` of V rows and a float32 or bfloat16 ``x`` of ``g.n_cols``
rows (V for a square graph), accumulated in float32
with the edge values in float32. It replaces the TPU kernel
``maxk_tpu/ops/pallas_spmm.py::_tile_reduce_kernel``.

Both versions follow the graph's segment plan (``ops/graph.py``
``SegmentPlan``): each segment of at most ``seg_len`` edges of a row is
summed on its own, and a split row sums its segments' partials in
segment order. On CUDA tensors ``spmm_csr`` launches
``csrc/spmm_csr.cu`` (one warp per segment, in passes of 128 columns of
x, then one block per split row; no atomics; see the source for its
bound and design). On CPU tensors it runs ``spmm_csr_plain``. There is
no fallback between the two, and a graph without a plan is refused.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from maxk_tpu_torch.ops.graph import DeviceCSR, SegmentPlan

# The plain version gathers at most this many (edge, feature) products at
# once, so it never holds E x D floats.
_PLAIN_CHUNK_ELEMS = 1 << 26


def _plan(g: DeviceCSR) -> SegmentPlan:
    if g.plan is None:
        raise ValueError("spmm: the graph has no segment plan; build it "
                         "with DeviceCSR.from_csr")
    return g.plan


def spmm_csr_plain(g: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """The plan's sums in torch ops: index_add_ of vals[:, None] * x[cols]
    into one float32 row per segment (chunked over edges), then each row
    takes its segment's row or, if split, the sum of its segments' rows
    in segment order."""
    plan = _plan(g)
    d, dev = x.shape[1], x.device
    # The segments cover the edges in order, each edge once.
    lengths = torch.clamp(g.indptr[plan.seg_row.long() + 1] - plan.seg_start,
                          max=plan.seg_len)
    seg_of_edge = torch.repeat_interleave(
        torch.arange(plan.n_segments, device=dev), lengths)
    seg = torch.zeros((plan.n_segments, d), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, d))
    for lo in range(0, g.indices.shape[0], step):
        cols = g.indices[lo:lo + step].long()
        contrib = g.values[lo:lo + step, None] * x[cols].float()
        seg.index_add_(0, seg_of_edge[lo:lo + step], contrib)
    return finish_plain(g, seg)


def finish_plain(g: DeviceCSR, seg: torch.Tensor) -> torch.Tensor:
    """The finish pass of the plan (``csrc/segment_plan.cuh``) on float32
    segment sums ``seg`` (n_segments, D): each row takes its segment's
    row or, if split, the sum of its segments' rows in segment order,
    from 0.0; zero-degree rows are zeros."""
    plan = _plan(g)
    d, dev = seg.shape[1], seg.device
    out = torch.zeros((g.n_nodes, d), dtype=torch.float32, device=dev)
    direct = plan.seg_slot < 0
    out[plan.seg_row[direct].long()] = seg[direct]
    # Split rows: step j adds every split row's j-th partial, in order;
    # rows sorted by segment count, so step j's rows are a prefix.
    partials = seg[~direct]
    counts = torch.diff(plan.fin_ptr)
    order = torch.argsort(counts, descending=True, stable=True)
    counts_sorted = counts[order].cpu().numpy()
    acc = torch.zeros((counts.shape[0], d), dtype=torch.float32, device=dev)
    for j in range(int(counts_sorted[0]) if counts_sorted.size else 0):
        idx = order[:int(np.count_nonzero(counts_sorted > j))]
        acc[idx] += partials[plan.fin_ptr[idx] + j]
    out[plan.fin_row.long()] = acc
    return out


@functools.cache
def _kernel(dtype: torch.dtype):
    from maxk_tpu_torch.native.build import load
    lib = load("spmm_csr")
    fn = lib.spmm_csr_bf16 if dtype == torch.bfloat16 else lib.spmm_csr_f32
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(g: DeviceCSR, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm: need a 2-D float32 or bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] != g.n_cols:
        raise ValueError(f"spmm: x has {x.shape[0]} rows, graph has "
                         f"{g.n_cols} columns")
    if (g.indptr.dtype != torch.int64 or g.indices.dtype != torch.int32
            or g.values.dtype != torch.float32):
        raise ValueError("spmm: need int64 indptr, int32 indices, float32 "
                         "values")
    plan = _plan(g)
    if not (g.indptr.device == g.indices.device == g.values.device
            == plan.seg_row.device == x.device):
        raise ValueError(f"spmm: graph on {g.device}, plan on "
                         f"{plan.seg_row.device}, x on {x.device}")


def spmm_csr(g: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """float32 A @ x; the kernel on CUDA tensors."""
    _check(g, x)
    if x.device.type == "cpu":
        return spmm_csr_plain(g, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {x.device}")
    plan = g.plan
    for name, t in (("x", x), ("indptr", g.indptr),
                    ("indices", g.indices), ("values", g.values)):
        if not t.is_contiguous():
            raise ValueError(f"spmm kernel: {name} must be contiguous")
    v, d = g.n_nodes, x.shape[1]
    out = torch.empty((v, d), dtype=torch.float32, device=x.device)
    if v == 0 or d == 0:
        return out
    partials = torch.empty((plan.n_partials, d), dtype=torch.float32,
                           device=x.device)
    # 4-element vector loads need whole vectors per row and an aligned
    # base; otherwise scalar loads.
    elem = x.element_size()
    vec = 4 if d % 4 == 0 and x.data_ptr() % (4 * elem) == 0 else 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(x.dtype)(
            g.indptr.data_ptr(), g.indices.data_ptr(), g.values.data_ptr(),
            x.data_ptr(), out.data_ptr(), partials.data_ptr(),
            plan.seg_row.data_ptr(), plan.seg_start.data_ptr(),
            plan.seg_slot.data_ptr(), plan.n_segments, plan.seg_len,
            plan.fin_row.data_ptr(), plan.fin_ptr.data_ptr(),
            plan.fin_row.shape[0], d, vec, stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed: CUDA error "
                           f"{err}")
    spmm_csr.launches += 1
    return out


spmm_csr.launches = 0
