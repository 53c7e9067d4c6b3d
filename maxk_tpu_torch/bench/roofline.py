"""Roofline audit of K2, the CSR SpMM, and K7, its int8 variant, against
an H100 machine model.

The reference ships wall-clock timing only (reference kernels/util.h:4-9,
spmm_base.h:58-74). Here every baseline SpMM is audited against a model
of what K2 (``csrc/spmm_csr.cu``) must do, by phase:

- HBM streaming at ``hbm_bytes_per_s``: the bf16 cast of an f32 x (read
  f32, write bf16), indptr, the segment plan, cols and vals, x read once,
  out written, the split rows' partials written and read back;
- the row gather, E*D*elem bytes (each edge pulls its row of x, mostly
  from L2; elem 1 for K7's int8 table, plus a 4-byte scale an edge under
  the row scale) at ``gather_bytes_per_s``;
- the f32 FMAs, 2*E*D operations at ``fp32_flops_per_s``.

``audit_spmm`` returns two references: ``floor_ms`` (the largest phase,
the ideal-overlap lower bound) and ``serial_ms`` (their sum, the
no-overlap model). ``efficiency`` is the serial model over the achieved
time, capped at 1.

For K7 the model counts no instruction but the FMAs: not the int-to-float
conversion of each value (a byte permute and an add; at first one I2F)
nor each edge's shuffles, address and loop, which set its pace at
~15 values a clock an SM (PERF.md). Its share of this model measures it
against a bound that leaves those out.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
The gather rate is measured: ``gather_probe`` (csrc/gather_probe.cu, K2's
reads alone, 4 loads in flight a lane as in K2) over the cols of
synthetic_graph(131072, 50.0, seed=123), E = 13,107,200, into a bfloat16
x of 256 columns read 0.8427 ms, 7.96e12 bytes/s, on an NVIDIA H100
80GB HBM3 at a 700 W power limit (chip_smoke.py phase 17, which measures
it again on every run).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from maxk_tpu_torch.ops.graph import SegmentPlan

H100 = dict(hbm_bytes_per_s=3.35e12, fp32_flops_per_s=67e12,
            gather_bytes_per_s=7.96e12)


@dataclasses.dataclass
class RooflineReport:
    time_ms: float
    floor_ms: float              # max of phases (ideal overlap)
    serial_ms: float             # sum of phases (no overlap)
    efficiency: float            # serial_ms / achieved (1.0 = at model)
    gather_ms: float
    stream_ms: float
    fma_ms: float
    bound: str                   # 'gather' | 'stream' | 'fma'
    achieved_gnnz_s: float

    def summary(self) -> str:
        return (f"{self.time_ms:.4f} ms vs serial model "
                f"{self.serial_ms:.4f} ms / overlap floor "
                f"{self.floor_ms:.4f} ms ({100*self.efficiency:.0f}% of "
                f"model, {self.bound}-bound: gather {self.gather_ms:.4f} / "
                f"stream {self.stream_ms:.4f} / fma {self.fma_ms:.4f} ms; "
                f"{self.achieved_gnnz_s:.2f} Gnnz/s)")


def stream_bytes(n_nodes: int, n_edges: int, dim: int, plan: SegmentPlan,
                 value_bytes: int = 2, x_in_bytes: int = 4,
                 scale: Optional[str] = None) -> int:
    """The bytes K2's (or K7's) call moves to and from HBM once each (see
    the module docstring); x arrives as x_in_bytes a value and is cast to
    value_bytes first unless the two are equal. Under an int8 scale
    (value_bytes 1): "column" quantizes x in the call (a max pass and a
    quantize pass read x, the int8 table is written, and D scales);
    "row" reads K6's per-row scales, whose table arrives built."""
    n_fin = int(plan.fin_row.shape[0])
    if scale == "column":
        prep = n_nodes * dim * (2 * x_in_bytes + value_bytes) + dim * 4
    elif scale == "row":
        prep = n_nodes * 4
    else:
        prep = n_nodes * dim * (x_in_bytes + value_bytes) \
            if x_in_bytes != value_bytes else 0
    return (prep + (n_nodes + 1) * 8
            + plan.n_segments * (4 + 8 + 4) + n_fin * 4 + (n_fin + 1) * 8
            + n_edges * (4 + 4)
            + n_nodes * dim * value_bytes + n_nodes * dim * 4
            + plan.n_partials * dim * 4 * 2)


def audit_spmm(n_nodes: int, n_edges: int, dim: int, time_ms: float,
               plan: SegmentPlan, value_bytes: int = 2,
               x_in_bytes: int = 4, model: dict = H100,
               scale: Optional[str] = None) -> RooflineReport:
    """Roofline audit of one K2 call through ``ops/spmm.py::spmm`` on the
    graph whose segment plan is `plan`; value_bytes is the gathered
    element's width (the JAX audit's ``pack``): 2 for bfloat16, 4 for
    float32, 1 for K7's int8 table, whose scale ("column" or "row") adds
    its bytes (``stream_bytes``) and, per row, one 4-byte scale an edge
    to the gather."""
    if model.get("gather_bytes_per_s") is None:
        raise ValueError("roofline model has no measured gather rate")
    gathered = n_edges * (dim * value_bytes + (4 if scale == "row" else 0))
    gather_s = gathered / model["gather_bytes_per_s"]
    stream_s = (stream_bytes(n_nodes, n_edges, dim, plan, value_bytes,
                             x_in_bytes, scale) / model["hbm_bytes_per_s"])
    fma_s = 2 * n_edges * dim / model["fp32_flops_per_s"]
    parts = {"gather": gather_s, "stream": stream_s, "fma": fma_s}
    serial_s = gather_s + stream_s + fma_s
    return RooflineReport(
        time_ms=time_ms, floor_ms=max(parts.values()) * 1e3,
        serial_ms=serial_s * 1e3,
        efficiency=min(1.0, serial_s * 1e3 / max(time_ms, 1e-9)),
        gather_ms=gather_s * 1e3, stream_ms=stream_s * 1e3,
        fma_ms=fma_s * 1e3, bound=max(parts, key=parts.get),
        achieved_gnnz_s=n_edges / (time_ms * 1e-3) / 1e9)


@functools.cache
def _probe():
    from maxk_tpu_torch.native.build import load
    fn = load("gather_probe").gather_probe_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_probe(x: torch.Tensor, cols: torch.Tensor,
                 in_flight: int = 4) -> torch.Tensor:
    """Launch csrc/gather_probe.cu: read x[cols[e], :] for every edge, as
    K2 does, and nothing else, with `in_flight` (4, as K2, or 8) loads in
    flight a lane. x: contiguous CUDA bfloat16 (V, D), D % 4 == 0; cols:
    CUDA int32 (E,) in [0, V). Returns the per-warp XOR folds (only so
    that the reads are not dead code)."""
    if x.device.type != "cuda" or cols.device != x.device:
        raise ValueError("gather_probe: x and cols must be on one CUDA "
                         "device")
    if (x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or x.shape[1] % 4 or x.data_ptr() % 8):
        raise ValueError("gather_probe: need a contiguous, 8-byte-aligned "
                         "bfloat16 (V, D) x with D % 4 == 0")
    if cols.dtype != torch.int32 or cols.dim() != 1 \
            or not cols.is_contiguous():
        raise ValueError("gather_probe: need contiguous int32 cols")
    if in_flight not in (4, 8):
        raise ValueError(f"gather_probe: in_flight is 4 or 8, not "
                         f"{in_flight}")
    e, d = cols.shape[0], x.shape[1]
    out = torch.empty((-(-e // 256), -(-d // 128), 32, 2), dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _probe()(x.data_ptr(), cols.data_ptr(), e, d, in_flight,
                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_probe launch failed: CUDA error {err}")
    return out
