"""K7: CSR SpMM over an int8 table, as a CUDA kernel and its plain version.

``spmm_int8_csr(g, q, scale, row_scale)`` returns the float32 ``(V, D)``
product of a ``DeviceCSR`` and a dequantized int8 table: ``q`` (n_cols,
D) int8 with D % 4 == 0, and either a per-column ``scale`` (D,) float32
(``row_scale=False``, the JAX package's ``"int8"`` mode)

    out[r, f] = scale[f] * sum_{e in row r} vals[e] * q[cols[e], f]

or a per-row ``scale`` (n_cols,) float32 (``row_scale=True``, its
``"int8_rowscale"`` mode)

    out[r, f] = sum_{e in row r} (vals[e] * scale[cols[e]]) * q[cols[e], f]

accumulated in float32 with the edge weights in float32. The JAX package
computes the same function in XLA scans (``maxk_tpu/ops/spmm.py``
``_spmm_scan`` under "int8", ``maxk_tpu/ops/spgemm.py::_rowscale_impl``),
where it rounds the one-hot operand and the row-scaled weights to
bfloat16; here they stay float32, as on K2's bfloat16 path, so the two
differ by at most 2**-8 of the sum of |terms| an element.

Both versions follow the graph's segment plan, as K2 does
(``ops/cuda_spmm.py``). On CUDA tensors ``spmm_int8_csr`` launches
``csrc/spmm_int8.cu`` (one warp a segment, in passes of ``SLAB`` columns;
see the source for its bound and design). On CPU tensors it runs
``spmm_int8_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from maxk_tpu_torch.ops.cuda_spmm import _PLAIN_CHUNK_ELEMS, _plan, finish_plain
from maxk_tpu_torch.ops.graph import DeviceCSR

# Columns a warp covers in one pass over the table: 128 (4-byte loads) or
# 256 (8-byte loads, D % 8 == 0). The two give the same bits. chip_smoke.py
# times both at the cell (phase 23) and at the reddit shape (phase 20); a
# pass costs each edge its CSR loads, shuffles and loop again, so 128 took
# 1.4-1.5 times as long at both, though at the reddit shape a 128-column
# slab of the int8 table (29.8 MB) fits the 50 MB L2 and the whole table
# (59.6 MB) does not (PERF.md).
SLAB = 256
# The float32 2**23 + 128: K7 puts q + 128 in the low byte of 2**23's bits.
_MAGIC_BITS = 0x4B000000
_MAGIC_BIAS = 8388736.0


def int8_to_float(q: torch.Tensor) -> torch.Tensor:
    """int8 q as float32, the way K7 converts it (no int-to-float
    conversion): the byte with its sign bit flipped, q + 128, under the
    exponent of 2**23, less 2**23 + 128. Exact: equal to q.float()."""
    bits = (q.view(torch.uint8) ^ 0x80).to(torch.int32) | _MAGIC_BITS
    return bits.view(torch.float32) - _MAGIC_BIAS


def spmm_int8_plain(g: DeviceCSR, q: torch.Tensor, scale: torch.Tensor,
                    row_scale: bool) -> torch.Tensor:
    """K2's plain version reading int8: index_add_ of w[:, None] *
    q[cols] (converted as K7 converts it, ``int8_to_float``) into one
    float32 row per segment (chunked over edges), w = vals (times
    scale[cols] under the row scale), then the plan's finish, then the
    column scale."""
    plan = _plan(g)
    d, dev = q.shape[1], q.device
    lengths = torch.clamp(g.indptr[plan.seg_row.long() + 1] - plan.seg_start,
                          max=plan.seg_len)
    seg_of_edge = torch.repeat_interleave(
        torch.arange(plan.n_segments, device=dev), lengths)
    seg = torch.zeros((plan.n_segments, d), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, d))
    for lo in range(0, g.indices.shape[0], step):
        cols = g.indices[lo:lo + step].long()
        w = g.values[lo:lo + step]
        if row_scale:
            w = w * scale[cols]
        seg.index_add_(0, seg_of_edge[lo:lo + step],
                       w[:, None] * int8_to_float(q[cols]))
    out = finish_plain(g, seg)
    return out if row_scale else out * scale


@functools.cache
def _kernel():
    from maxk_tpu_torch.native.build import load
    fn = load("spmm_int8").spmm_int8
    fn.argtypes = ([ctypes.c_void_p] * 10
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(g: DeviceCSR, q: torch.Tensor, scale: torch.Tensor,
           row_scale: bool) -> None:
    if q.dim() != 2 or q.dtype != torch.int8 or q.shape[1] % 4:
        raise ValueError(f"spmm_int8: need a 2-D int8 table with D % 4 == "
                         f"0, got {tuple(q.shape)} {q.dtype}")
    if q.shape[0] != g.n_cols:
        raise ValueError(f"spmm_int8: the table has {q.shape[0]} rows, "
                         f"graph has {g.n_cols} columns")
    want = q.shape[0] if row_scale else q.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (want,):
        raise ValueError(f"spmm_int8: need a float32 scale of ({want},), got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if (g.indptr.dtype != torch.int64 or g.indices.dtype != torch.int32
            or g.values.dtype != torch.float32):
        raise ValueError("spmm_int8: need int64 indptr, int32 indices, "
                         "float32 values")
    plan = _plan(g)
    if not (g.indices.device == plan.seg_row.device == q.device
            == scale.device):
        raise ValueError(f"spmm_int8: graph on {g.device}, plan on "
                         f"{plan.seg_row.device}, table on {q.device}, "
                         f"scale on {scale.device}")


def spmm_int8_csr(g: DeviceCSR, q: torch.Tensor, scale: torch.Tensor,
                  row_scale: bool, slab: Optional[int] = None
                  ) -> torch.Tensor:
    """float32 A @ dequant(q, scale); the kernel on CUDA tensors, in passes
    of `slab` columns (SLAB by default; at D % 8 != 0, 128: 256 loads 8
    bytes a lane)."""
    _check(g, q, scale, row_scale)
    if q.device.type == "cpu":
        return spmm_int8_plain(g, q, scale, row_scale)
    if q.device.type != "cuda":
        raise ValueError(f"spmm_int8: unsupported device {q.device}")
    for name, t in (("q", q), ("scale", scale), ("indptr", g.indptr),
                    ("indices", g.indices), ("values", g.values)):
        if not t.is_contiguous():
            raise ValueError(f"spmm_int8 kernel: {name} must be contiguous")
    v, d = g.n_nodes, q.shape[1]
    slab = SLAB if slab is None else slab
    if slab == 256 and d % 8:
        slab = 128
    if slab not in (128, 256) or q.data_ptr() % (slab // 32):
        raise ValueError(f"spmm_int8 kernel: slab {slab} needs a table "
                         f"aligned to {slab // 32} bytes")
    plan = g.plan
    out = torch.empty((v, d), dtype=torch.float32, device=q.device)
    if v == 0 or d == 0:
        return out
    partials = torch.empty((plan.n_partials, d), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            g.indptr.data_ptr(), g.indices.data_ptr(), g.values.data_ptr(),
            q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partials.data_ptr(), plan.seg_row.data_ptr(),
            plan.seg_start.data_ptr(), plan.seg_slot.data_ptr(),
            plan.n_segments, plan.seg_len, plan.fin_row.data_ptr(),
            plan.fin_ptr.data_ptr(), plan.fin_row.shape[0], d,
            int(row_scale), slab, stream)
    if err != 0:
        raise RuntimeError(f"spmm_int8 kernel launch failed: CUDA error "
                           f"{err}")
    spmm_int8_csr.launches += 1
    return out


spmm_int8_csr.launches = 0
