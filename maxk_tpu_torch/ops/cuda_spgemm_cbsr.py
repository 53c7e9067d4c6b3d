"""K5: the CBSR-operand forward SpGEMM, as a CUDA kernel and its plain
PyTorch version.

``spgemm_cbsr_csr(g, values, selector, dim)`` returns the float32
``(V, dim)`` product ``A @ cbsr_expand(values, selector, dim)`` of a
``DeviceCSR`` of V rows and a CBSR table of ``g.n_cols`` rows: ``values``
(n_cols, k) float32 or bfloat16 and ``selector`` (n_cols, k) uint8, with
float32 accumulation and the edge values in float32. It reads k kept
entries per edge, never the expanded row. It replaces the JAX
package's CBSR-operand formulation, the XLA scan
``maxk_tpu/ops/spgemm.py::_spgemm_cbsr_impl`` (``CBSR_GATHER_MODE``); no
Pallas kernel computes it.

Both versions follow the graph's segment plan (``ops/graph.py``
``SegmentPlan``) and apply each segment's edges in CSR order, one
correctly rounded fused multiply-add per kept entry: a column's sum is
``fmaf(w, v, acc)`` over its edges, from 0.0. Split rows sum their
segments' partials in segment order (``cuda_spmm.finish_plain``). So the
two versions agree bit for bit, and both equal K2 on the expanded operand
(``spmm_csr(g, cbsr_expand(values, selector, dim))``) up to the sign of a
zero sum. On CUDA tensors ``spgemm_cbsr_csr`` launches
``csrc/spgemm_cbsr.cu``: with bfloat16 values a pack pass that writes
one record per kept entry (``pack_records``, whose plain version is
``pack_records_plain``), then one warp per item of the plan's work list
(``SegmentPlan.work``) with a shared-memory row per segment, up to four
segments a warp at small k; see the source. On CPU tensors it runs
``spgemm_cbsr_plain``. There is no fallback between the two. It refuses
``dim > 256`` (uint8 selectors), ``k > 128`` (the JAX package's
``_CBSR_GATHER_MAX_K``) and any selector type but uint8.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maxk_tpu_torch.ops.cuda_spmm import finish_plain
from maxk_tpu_torch.ops.graph import DeviceCSR

MAX_DIM = 256
MAX_K = 128


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as CUDA's fmaf. The product
    is exact in float64; the sum's rounding error comes from TwoSum, and
    the float64 sum is rounded to odd before its one rounding to float32,
    which makes that rounding correct (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    # Round to odd: an inexact sum whose last bit is even moves one unit
    # toward the exact value.
    nudge = (err != 0) & torch.isfinite(err) & ((bits & 1) == 0)
    step = torch.where((s > 0) == (err > 0), 1, -1)
    return (bits + torch.where(nudge, step, 0)).view(torch.float64).float()


def pack_records_plain(values: torch.Tensor,
                       selector: torch.Tensor) -> torch.Tensor:
    """The kernel's records of a CBSR table with bfloat16 values: an
    int32 ``(n, k)`` of ``bf16 bits << 16 | selector``."""
    if values.dtype != torch.bfloat16:
        raise ValueError(f"pack_records: need bfloat16 values, got "
                         f"{values.dtype}")
    rec = ((values.view(torch.int16).to(torch.int64) & 0xFFFF) << 16
           | selector.to(torch.int64))
    # The 32-bit pattern as a signed int32, exactly.
    return torch.where(rec >= 2**31, rec - 2**32, rec).to(torch.int32)


def spgemm_cbsr_plain(g: DeviceCSR, values: torch.Tensor,
                      selector: torch.Tensor, dim: int) -> torch.Tensor:
    """The plan's sums in torch ops: the j-th edge of every segment at
    once, for j = 0, 1, ..., its products vals[e] * values[cols[e]]
    fused into the segment's row at selector[cols[e]] (``fma_f32``), then
    ``finish_plain``. Within a step each segment takes one edge, whose
    selectors are distinct, so no column is written twice."""
    plan = g.plan
    dev = values.device
    # Longest first, so step j's segments are a prefix.
    order = torch.argsort(plan.seg_edges, descending=True, stable=True)
    lengths_sorted = plan.seg_edges[order].cpu()
    seg = torch.zeros((plan.n_segments, dim), dtype=torch.float32,
                      device=dev)
    flat = seg.view(-1)
    for j in range(int(lengths_sorted[0]) if len(lengths_sorted) else 0):
        active = order[:int((lengths_sorted > j).sum())]
        e = plan.seg_start[active] + j
        cols = g.indices[e].long()
        at = active[:, None] * dim + selector[cols].long()
        flat[at] = fma_f32(g.values[e][:, None], values[cols].float(),
                           flat[at])
    return finish_plain(g, seg)


@functools.cache
def _lib():
    from maxk_tpu_torch.native.build import load
    lib = load("spgemm_cbsr")
    for name in ("bf16", "f32"):
        fn = getattr(lib, f"spgemm_cbsr_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 4
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.spgemm_cbsr_pack_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.spgemm_cbsr_pack_bf16.restype = ctypes.c_int
    return lib


def _check_table(values: torch.Tensor, selector: torch.Tensor) -> None:
    if values.dim() != 2 or values.dtype not in (torch.float32,
                                                 torch.bfloat16):
        raise ValueError(f"spgemm_cbsr: need 2-D float32 or bfloat16 "
                         f"values, got {tuple(values.shape)} "
                         f"{values.dtype}")
    if selector.dtype != torch.uint8 or selector.shape != values.shape:
        raise ValueError(f"spgemm_cbsr: need a uint8 selector of values' "
                         f"shape {tuple(values.shape)}, got "
                         f"{tuple(selector.shape)} {selector.dtype}")
    if values.device != selector.device:
        raise ValueError(f"spgemm_cbsr: values on {values.device}, "
                         f"selector on {selector.device}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spgemm_cbsr: unsupported device {values.device}")
    if values.device.type == "cuda" and not (values.is_contiguous()
                                             and selector.is_contiguous()):
        raise ValueError("spgemm_cbsr kernel: values and selector must be "
                         "contiguous")


def pack_records(values: torch.Tensor,
                 selector: torch.Tensor) -> torch.Tensor:
    """``pack_records_plain``'s records; on CUDA tensors by the pack
    kernel that ``spgemm_cbsr_csr`` runs first on bfloat16 values
    (launched alone here, for its check)."""
    _check_table(values, selector)
    if values.device.type == "cpu" or values.dtype != torch.bfloat16:
        return pack_records_plain(values, selector)   # raises on float32
    records = torch.empty(values.shape, dtype=torch.int32,
                          device=values.device)
    with torch.cuda.device(values.device):
        err = _lib().spgemm_cbsr_pack_bf16(
            values.data_ptr(), selector.data_ptr(), values.numel(),
            records.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spgemm_cbsr pack kernel launch failed: CUDA "
                           f"error {err}")
    pack_records.launches += 1
    return records


pack_records.launches = 0


def _check(g: DeviceCSR, values: torch.Tensor, selector: torch.Tensor,
           dim: int) -> None:
    _check_table(values, selector)
    k = values.shape[1]
    if not 1 <= dim <= MAX_DIM or not 1 <= k <= min(MAX_K, dim):
        raise ValueError(f"spgemm_cbsr: need dim <= {MAX_DIM} and "
                         f"1 <= k <= min({MAX_K}, dim), got dim={dim}, "
                         f"k={k}")
    if values.shape[0] != g.n_cols:
        raise ValueError(f"spgemm_cbsr: the table has {values.shape[0]} "
                         f"rows, graph has {g.n_cols} columns")
    if (g.indptr.dtype != torch.int64 or g.indices.dtype != torch.int32
            or g.values.dtype != torch.float32):
        raise ValueError("spgemm_cbsr: need int64 indptr, int32 indices, "
                         "float32 values")
    if g.plan is None:
        raise ValueError("spgemm_cbsr: the graph has no segment plan; "
                         "build it with DeviceCSR.from_csr")
    if not (g.indptr.device == g.indices.device == g.values.device
            == g.plan.seg_row.device == values.device):
        raise ValueError(f"spgemm_cbsr: graph on {g.device}, plan on "
                         f"{g.plan.seg_row.device}, values on "
                         f"{values.device}")


def spgemm_cbsr_csr(g: DeviceCSR, values: torch.Tensor,
                    selector: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 A @ cbsr_expand(values, selector, dim); the kernel on CUDA
    tensors. Selectors must lie in [0, dim) and be distinct within a row
    (top-k selectors are): the kernel does not check them."""
    _check(g, values, selector, dim)
    if values.device.type == "cpu":
        return spgemm_cbsr_plain(g, values, selector, dim)
    for name, t in (("indices", g.indices), ("vals", g.values)):
        if not t.is_contiguous():
            raise ValueError(f"spgemm_cbsr kernel: {name} must be "
                             f"contiguous")
    plan = g.plan
    dev = values.device
    out = torch.empty((g.n_nodes, dim), dtype=torch.float32, device=dev)
    if g.n_nodes == 0:
        return out
    partials = torch.empty((plan.n_partials, dim), dtype=torch.float32,
                           device=dev)
    bf16 = values.dtype == torch.bfloat16
    # The pack pass's records (bfloat16 values only).
    records = (torch.empty(values.shape, dtype=torch.int32, device=dev)
               if bf16 else None)
    with torch.cuda.device(dev):
        err = (_lib().spgemm_cbsr_bf16 if bf16 else _lib().spgemm_cbsr_f32)(
            g.indices.data_ptr(), g.values.data_ptr(), values.data_ptr(),
            selector.data_ptr(), values.shape[0],
            records.data_ptr() if bf16 else None,
            plan.work.data_ptr(), plan.n_segments, out.data_ptr(),
            partials.data_ptr(), plan.fin_row.data_ptr(),
            plan.fin_ptr.data_ptr(), plan.fin_row.shape[0], values.shape[1],
            dim, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"spgemm_cbsr kernel launch failed: CUDA error "
                           f"{err}")
    spgemm_cbsr_csr.launches += 1
    return out


spgemm_cbsr_csr.launches = 0
