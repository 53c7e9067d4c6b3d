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
80GB HBM3 at a 700 W power limit (``python -m
maxk_tpu_torch.bench.kernel_table`` measures it again: its gather_rate
line).

``project_multichip`` projects row-partitioned training over several
H100s joined by NVLink (``maxk_tpu/bench/roofline.py``'s projection,
rewritten for the port's shards): the compute term of an aggregation is
the bytes K2 moves on the largest shard (``sharded_k2_bytes``) over K2's
rate, the comm term the halo rows a shard receives over NVLink.
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


# NVLink 4 on an H100 SXM5: 900 GB/s total bandwidth a GPU, both ways
# together (NVIDIA H100 Tensor Core GPU data sheet), so 450 GB/s each way:
# the rate at which a card receives its halo rows from its peers.
NVLINK_GBPS = 450.0

# K2's rate at the cell (PERF.md section 5): 6.71 GB of bfloat16 rows
# gathered a launch (E = 13,107,200, D = 256) in 1.1227 ms, 6.00e12
# bytes/s, on an NVIDIA H100 80GB HBM3 at a 700 W power limit
# (bench/kernel_table.py's gather_rate line). scaling_bench measures it
# again on a sweep that holds one graph shard.
K2_BYTES_PER_S = 6.00e12


def k2_bytes(n_nodes: int, n_edges: int, dim: int, plan: SegmentPlan,
             value_bytes: int = 2, x_in_bytes: int = 4) -> int:
    """The bytes one K2 call moves: the gathered rows (E * D *
    value_bytes) and what ``stream_bytes`` counts on the graph's plan."""
    return (n_edges * dim * value_bytes
            + stream_bytes(n_nodes, n_edges, dim, plan, value_bytes,
                           x_in_bytes))


def sharded_k2_bytes(sg, dim: int, value_bytes: int = 2,
                     x_in_bytes: int = 4) -> int:
    """``k2_bytes`` of the largest shard of a ShardedGraph
    (``parallel/partition.py``), each on its own segment plan: a step
    waits for its slowest shard."""
    return max(k2_bytes(g.n_nodes, g.n_edges, dim, SegmentPlan.build(g),
                        value_bytes, x_in_bytes) for g in sg.shards)


def project_multichip(n_shards: int, compute_ms_per_agg: float,
                      compute1_ms_per_agg: float, halo_rows: int, dim: int,
                      k: int, n_aggregations: int,
                      nvlink_gbps: float = NVLINK_GBPS) -> dict:
    """First-order scaling projection of row-partitioned training over
    ``n_shards`` cards, for a step of ``n_aggregations`` aggregations
    (2 a layer: forward and transpose).

    Per aggregation:
      compute_ms: K2 on a shard (``sharded_k2_bytes`` over K2's rate);
        compute1_ms the same on the whole graph (one card);
      comm_ms: the rows a card receives, (S-1) * halo_rows, over
        ``nvlink_gbps``: bfloat16 rows of 2 * dim bytes (the dense
        exchange), or 3 * k bytes (the CBSR wire: bfloat16 values and
        uint8 selectors).
    Two bounds: serial (compute + comm) and overlap (max of the two: the
    local rows' work does not wait for the exchange). Returns the JAX
    projection's keys: ms a step, speedup and efficiency against one
    card, for each wire, and the wire's reduction.
    """
    peer_rows = (n_shards - 1) * halo_rows
    comm_dense_ms = peer_rows * dim * 2 / (nvlink_gbps * 1e9) * 1e3
    comm_cbsr_ms = peer_rows * 3 * k / (nvlink_gbps * 1e9) * 1e3
    comp_ms, comp1_ms = compute_ms_per_agg, compute1_ms_per_agg

    def step(comm_ms):
        serial = n_aggregations * (comp_ms + comm_ms)
        overlap = n_aggregations * max(comp_ms, comm_ms)
        t1 = n_aggregations * comp1_ms
        return dict(
            step_serial_ms=round(serial, 4),
            step_overlap_ms=round(overlap, 4),
            speedup_serial=round(t1 / serial, 3) if serial else float("inf"),
            speedup_overlap=round(t1 / overlap, 3) if overlap else
            float("inf"),
            efficiency_serial=round(t1 / serial / n_shards, 3) if serial
            else 1.0,
            efficiency_overlap=round(t1 / overlap / n_shards, 3) if overlap
            else 1.0)

    return dict(
        n_shards=n_shards,
        compute_ms_per_agg=round(comp_ms, 4),
        comm_dense_ms_per_agg=round(comm_dense_ms, 4),
        comm_cbsr_ms_per_agg=round(comm_cbsr_ms, 4),
        wire_reduction=round(comm_dense_ms / comm_cbsr_ms, 2)
        if comm_cbsr_ms else float("inf"),
        dense=step(comm_dense_ms), cbsr=step(comm_cbsr_ms))
