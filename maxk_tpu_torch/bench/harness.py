"""Kernel benchmark harness: the port of ``maxk_tpu/bench/harness.py``,
the replica of the reference benchmark stack (C++ CLI
kernels/main.cu:50-222 and Python runner main_runner_direct.py:19-213),
on one CUDA device (or, for tests, the CPU).

Per graph, at dim_origin=256 (reference kernels/main.cu:52):
  - library-baseline SpMM on the dense input, 10 warmup + 10 timed runs
    (the role cuSPARSE plays in the reference, spmm_cusparse.cu:35-51).
    The baseline is the production ``spmm`` (K2 at its default bf16
    compute), so every reported speedup answers "is MaxK faster than not
    using MaxK at all";
  - unweighted neighbor-sum SpMM (the GNNAdvisor SAG-kernel analog in
    torch ops, ``ops/gnna.py``; reference kernels/spmm_gnna.cu:60-140);
  - per k in {16, 32, 64} (main.cu:53-54,113-116): TopK->CBSR timing
    (K4), the CBSR forward SpGEMM (expansion, then K2; K5 under
    ``maxk_tpu_torch.ops.spgemm.CBSR_GATHER_MODE``), the mask-route
    forward (K1, then K2) and the sampled backward SSpMM (K2, then K3),
    4 warmup + 4 timed runs each (spmm_base.h:58-74);
  - numerical validation at the first k: forward output vs a host numpy
    oracle on the densified CBSR input, mean abs err < 1e-3 with
    per-element flags at 0.1 (main.cu:19-48), plus backward vs oracle;
  - stdout lines `num graph dim_origin dim_k kernel time(ms)`
    (main.cu:109,165-172).

Speedup analysis mirrors main_runner_direct.py:138-213: graphs with
avg degree > 50, per-k geomean speedup vs the baseline, compared against
the paper's published A100 table.
"""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import tempfile
from typing import Optional, Sequence, Union

import numpy as np
import torch

from maxk_tpu_torch.bench.timing import time_fn
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, resolve_device

# Published A100 speedups vs cuSPARSE for avg-degree>50 graphs
# (reference README.md:136 keys them k=8/16/32/64; the analysis script
# re-keys the same numbers as k=16/32/64 — main_runner_direct.py:203).
# The README attributes these to the backward SSpMM ("SSpMM speedup vs
# cuSPARSE"); they are compared against BOTH columns in the analysis.
PAPER_SPEEDUPS = {16: 6.93, 32: 5.39, 64: 2.55}

DIM_ORIGIN = 256           # reference kernels/main.cu:52
DEFAULT_KS = (16, 32, 64)  # reference kernels/main.cu:53-54,113-116

# Measurement-protocol stamp of every result, so that --resume-json never
# mixes records timed another way. The JAX package stamps integers (its
# TPU protocols); this port's records carry their own:
#   "torch-1": bench/timing.py, CUDA events around 20 calls queued behind
#              a sleeping device; the H100 roofline of bench/roofline.py.
PROTOCOL = "torch-1"


@dataclasses.dataclass
class GraphBenchResult:
    graph: str
    n_nodes: int
    n_edges: int
    avg_degree: float
    dim: int
    baseline_ms: float                 # library SpMM (cuSPARSE analog)
    gnna_ms: Optional[float]           # unweighted-sum SpMM (GNNA analog)
    topk_ms: dict                      # k -> ms
    forward_ms: dict                   # k -> ms
    backward_ms: dict                  # k -> ms
    validation: Optional[dict]         # {passed, mean_err, max_err, k}
    roofline: Optional[dict] = None    # audit of the baseline SpMM
    # Dense backward baseline: transpose SpMM at full dim (what training
    # without MaxK pays for dX = A^T dY) — the denominator of the
    # reference's headline SSpMM table (README.md:136).
    backward_baseline_ms: Optional[float] = None
    coo_ms: Optional[float] = None     # COO SpMM (cuSPARSE COO analog)
    # Mask-route fused forward (k -> ms): what TRAINING pays per
    # aggregation (K1 then K2), next to the CBSR-protocol forward_ms the
    # reference benchmarks.
    fused_mask_ms: Optional[dict] = None
    protocol: Union[int, str] = PROTOCOL

    def speedup(self, k: int) -> Optional[float]:
        f = self.forward_ms.get(k)
        return self.baseline_ms / f if f else None

    def backward_speedup(self, k: int) -> Optional[float]:
        b = self.backward_ms.get(k)
        if not b or not self.backward_baseline_ms:
            return None
        return self.backward_baseline_ms / b

    def as_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["speedups"] = {k: self.speedup(k) for k in self.forward_ms}
        d["backward_speedups"] = {k: self.backward_speedup(k)
                                  for k in self.backward_ms}
        return d

    @classmethod
    def from_json(cls, d: dict) -> "GraphBenchResult":
        """Rebuild a result from an as_json record (JSON stringifies the
        int k keys of the per-k dicts); used by kernel_bench --resume-json
        to continue a suite past already-measured graphs."""
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in fields}
        # Records written before the protocol stamp existed are protocol-1
        # (the JAX package's first) — never let them default to current.
        d.setdefault("protocol", 1)
        for name in ("topk_ms", "forward_ms", "backward_ms"):
            d[name] = {int(k): v for k, v in (d.get(name) or {}).items()}
        if d.get("fused_mask_ms") is not None:
            d["fused_mask_ms"] = {int(k): v
                                  for k, v in d["fused_mask_ms"].items()}
        return cls(**d)

    def fused_mask_speedup(self, k: int) -> Optional[float]:
        f = (self.fused_mask_ms or {}).get(k)
        return self.baseline_ms / f if f else None


def device_info(device) -> dict:
    """What a record file says of the device it was measured on: on CUDA
    the card as ``nvidia-smi`` names it, with its power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"platform": "gpu", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(device)}


def _csr_spmm_numpy(indptr, indices, vals, dense,
                    edges_per_chunk: int = 4_000_000) -> np.ndarray:
    """Chunked numpy CSR x dense oracle, O(chunk) extra memory.

    A segment-sum oracle materializes the gathered (E, D) intermediate —
    63 GB in float32 at s24_soc_pokec (E = 61 M, D = 256) — so giant-graph
    validation reduces row blocks with np.add.reduceat over bounded
    gather chunks instead.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    d = dense.shape[1]
    out = np.zeros((n, d), dtype=np.float64)
    deg = np.diff(indptr)
    r0 = 0
    while r0 < n:
        # Extend the row block until it holds ~edges_per_chunk edges.
        r1 = int(np.searchsorted(indptr, indptr[r0] + edges_per_chunk,
                                 side="right")) - 1
        r1 = max(r1, r0 + 1)
        r1 = min(r1, n)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e1 > e0:
            gathered = dense[indices[e0:e1]].astype(np.float64)
            gathered *= vals[e0:e1, None]
            starts = indptr[r0:r1] - e0
            # Trailing empty rows start AT e1-e0 — reduceat rejects
            # out-of-range indices, and clamping them down would
            # truncate the previous row's segment. Exclude them (they
            # are zero rows) and reduce only in-range starts.
            mask = starts < (e1 - e0)
            res = np.add.reduceat(gathered, starts[mask], axis=0)
            blk = out[r0:r1]
            blk[mask] = res
            # reduceat mishandles empty MIDDLE segments too (returns the
            # element at the boundary instead of 0) — zero-degree rows
            # are zeroed.
            blk[deg[r0:r1] == 0] = 0.0
        r0 = r1
    return out


def _validate_fwd(g: DeviceCSR, csr: CSRGraph, v_np, s_np, k, dim) -> dict:
    """Forward validation against the host oracle (partial record; the
    backward half is added by _validate_bwd in the backward phase).

    Tolerances per reference kernels/main.cu:32-45: element flagged at
    abs err > 0.1; pass iff mean abs err < 1e-3. Validation runs at f32
    compute (the reference kernels are f32). The oracle runs on the host
    in chunked float64 numpy, so the device holds only the op under test.
    """
    from maxk_tpu_torch.ops.spgemm import spgemm_forward_cbsr

    y = spgemm_forward_cbsr(g, torch.from_numpy(v_np).to(g.device),
                            torch.from_numpy(s_np).to(g.device), dim,
                            compute_dtype=torch.float32)
    y_np = y.cpu().numpy().astype(np.float64)
    del y

    # Densified CBSR input (the reference validates against cuSPARSE on
    # the scattered dense mirror, main.cu:135-146).
    x_exp = np.zeros((csr.n_nodes, dim), dtype=np.float32)
    np.put_along_axis(x_exp, s_np.astype(np.int64), v_np, axis=1)
    y_ref = _csr_spmm_numpy(csr.indptr, csr.indices, csr.values, x_exp)

    err = np.abs(y_np - y_ref)
    scale = max(1.0, float(np.abs(y_ref).mean()))
    mean_err = float(err.mean() / scale)
    return dict(k=k, mean_err=mean_err,
                max_err=float(err.max() / scale),
                n_flagged=int((err / scale > 0.1).sum()),
                scale=scale, passed=bool(mean_err < 1e-3))


def _validate_bwd(g_t: DeviceCSR, csr_t: CSRGraph, s_np, dim,
                  validation: dict) -> dict:
    """Backward validation (sampled SSpMM vs host transpose oracle);
    completes the record started by _validate_fwd in place."""
    from maxk_tpu_torch.ops.spgemm import sspmm_sampled

    dy_np = np.random.default_rng(7).uniform(size=(csr_t.n_nodes, dim)) \
        .astype(np.float32)
    gc = sspmm_sampled(g_t, torch.from_numpy(dy_np).to(g_t.device),
                       torch.from_numpy(s_np).to(g_t.device),
                       compute_dtype=torch.float32)
    gc_np = gc.cpu().numpy().astype(np.float64)
    del gc

    dst = _csr_spmm_numpy(csr_t.indptr, csr_t.indices, csr_t.values, dy_np)
    gc_ref = np.take_along_axis(dst, s_np.astype(np.int64), axis=1)

    scale = validation.pop("scale", 1.0)
    berr = np.abs(gc_np - gc_ref)
    bwd_mean_err = float(berr.mean() / scale)
    validation["bwd_mean_err"] = bwd_mean_err
    validation["passed"] = bool(validation["passed"]
                                and bwd_mean_err < 1e-3)
    return validation


def _operands(csr: CSRGraph, dim: int, seed: int):
    """benchmark_graph's operands: edge values, then x, drawn from one
    seeded stream (reference seeds 123, main.cu:75). Returns (csr with
    the values, x, the stream)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 1.0, size=csr.n_edges).astype(np.float32)
    x = rng.uniform(0.0, 1.0, size=(csr.n_nodes, dim)).astype(np.float32)
    return csr.with_values(vals), x, rng


def _coo_operands(csr: CSRGraph, dev: torch.device):
    rows, cols = csr.to_coo()
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
            torch.from_numpy(csr.values).to(dev))


def benchmark_graph(csr: CSRGraph, name: str, dim: int = DIM_ORIGIN,
                    ks: Sequence[int] = DEFAULT_KS, validate: bool = True,
                    run_gnna: bool = True, run_coo: bool = False,
                    run_fused_mask: bool = True,
                    seed: int = 123,
                    log=print, device=None) -> GraphBenchResult:
    """Benchmark one graph, reference protocol (kernels/main.cu:50-185),
    on `device` (CUDA unless the caller asks otherwise).

    Two device phases so giants fit device memory: the forward phase
    holds (g, x) — baseline/COO/GNNA/TopK/fused forward — then frees
    them; the backward phase holds (g_t, dy) — transpose baseline and
    sampled SSpMM. Selectors cross phases as host arrays. The roofline
    audit is made on CUDA only: its model is the H100's.
    """
    from maxk_tpu_torch.bench.roofline import audit_spmm
    from maxk_tpu_torch.ops.cbsr import cbsr_topk
    from maxk_tpu_torch.ops.cuda_topk import maxk_forward
    from maxk_tpu_torch.ops.spgemm import spgemm_forward_cbsr, sspmm_sampled
    from maxk_tpu_torch.ops.spmm import spmm

    dev = resolve_device(device)
    csr, x, rng = _operands(csr, dim, seed)

    # ---- Forward phase: g + x resident. ----
    g = DeviceCSR.from_csr(csr, dev)
    xt = torch.from_numpy(x).to(dev)

    # Baseline: library SpMM on the dense input, 10+10 protocol.
    base = time_fn(lambda: spmm(g, xt), warmup=10, runs=10)
    log(f"0 {name} {dim} {dim} baseline_spmm {base.mean_ms:.4f}")

    audit = None
    if dev.type == "cuda":
        audit = audit_spmm(csr.n_nodes, csr.n_edges, dim, base.mean_ms,
                           g.plan)
        log(f"# roofline {name}: {audit.summary()}")
    else:
        log(f"# roofline {name}: not measured on {dev.type}")

    coo_ms = None
    if run_coo:
        # COO parity record (the reference harness times
        # spmm_cusparse_coo, kernels/spmm_cusparse.cu:65-119):
        # index_add_ in torch ops, comparator-grade timing (2+2).
        from maxk_tpu_torch.ops.spmm import spmm_coo
        rows_t, cols_t, vals_t = _coo_operands(csr, dev)
        coo = time_fn(lambda: spmm_coo(rows_t, cols_t, vals_t, xt,
                                       csr.n_nodes), warmup=2, runs=2)
        coo_ms = coo.mean_ms
        log(f"0 {name} {dim} {dim} coo_spmm {coo.mean_ms:.4f}")
        del rows_t, cols_t, vals_t

    gnna_ms = None
    if run_gnna:
        # Neighbor-group baseline (reference spmm_gnna.cu build_part +
        # SAG kernel), comparator-grade timing (2+2).
        from maxk_tpu_torch.ops.gnna import build_parts, spmm_gnna
        parts = build_parts(csr).to(dev)
        gnna = time_fn(lambda: spmm_gnna(parts, xt), warmup=2, runs=2)
        gnna_ms = gnna.mean_ms
        log(f"0 {name} {dim} {dim} gnna_sag {gnna.mean_ms:.4f}")
        del parts

    validation = None
    topk_ms, fwd_ms, bwd_ms = {}, {}, {}
    fused_ms = {} if run_fused_mask else None
    s_host = {}                      # k -> host selector for phase B
    for n, k in enumerate(ks):
        tk = time_fn(lambda: cbsr_topk(xt, k), warmup=4, runs=4)
        topk_ms[k] = tk.mean_ms
        log(f"{n} {name} {dim} {k} topk {tk.mean_ms:.4f}")

        v, s = cbsr_topk(xt, k)
        s_host[k] = s.cpu().numpy()
        if validate and n == 0:
            validation = _validate_fwd(g, csr, v.cpu().numpy(), s_host[k],
                                       k, dim)
            log(f"# validation k={k} fwd: "
                f"mean_err={validation['mean_err']:.2e} "
                f"max_err={validation['max_err']:.2e}")

        fw = time_fn(lambda: spgemm_forward_cbsr(g, v, s, dim), warmup=4,
                     runs=4)
        fwd_ms[k] = fw.mean_ms
        log(f"{n} {name} {dim} {k} maxk {fw.mean_ms:.4f}")
        del v, s

        if run_fused_mask:
            # Mask-route fused forward (the production training route,
            # ops/spgemm.py's default): K1's threshold, then K2, no CBSR
            # round trip.
            fm = time_fn(lambda: spmm(g, maxk_forward(xt, k)[0]), warmup=4,
                         runs=4)
            fused_ms[k] = fm.mean_ms
            log(f"{n} {name} {dim} {k} maxk_fused_mask {fm.mean_ms:.4f}")

    # ---- Backward phase: free (g, x), hold (g_t, dy). ----
    del g, xt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    csr_t = csr.transpose()
    g_t = DeviceCSR.from_csr(csr_t, dev)

    # Dense backward baseline: transpose SpMM at full dim — the cost a
    # non-MaxK training step pays for dX = A^T dY (reference headline
    # "SSpMM speedup vs cuSPARSE", README.md:136, is a backward number).
    dy = torch.from_numpy(rng.uniform(size=(csr.n_nodes, dim))
                          .astype(np.float32)).to(dev)
    bwd_base = time_fn(lambda: spmm(g_t, dy), warmup=4, runs=4)
    log(f"0 {name} {dim} {dim} baseline_spmm_T {bwd_base.mean_ms:.4f}")

    for n, k in enumerate(ks):
        s = torch.from_numpy(s_host[k]).to(dev)
        if validate and n == 0 and validation is not None:
            validation = _validate_bwd(g_t, csr_t, s_host[k], dim,
                                       validation)
            status = "pass" if validation["passed"] else "FAIL"
            log(f"# validation k={k}: mean_err={validation['mean_err']:.2e} "
                f"max_err={validation['max_err']:.2e} "
                f"bwd_mean_err={validation['bwd_mean_err']:.2e} [{status}]")
        bw = time_fn(lambda: sspmm_sampled(g_t, dy, s), warmup=4, runs=4)
        bwd_ms[k] = bw.mean_ms
        log(f"{n} {name} {dim} {k} maxk_backward {bw.mean_ms:.4f}")
        del s

    return GraphBenchResult(
        graph=name, n_nodes=csr.n_nodes, n_edges=csr.n_edges,
        avg_degree=csr.avg_degree, dim=dim, baseline_ms=base.mean_ms,
        gnna_ms=gnna_ms, topk_ms=topk_ms, forward_ms=fwd_ms,
        backward_ms=bwd_ms, validation=validation,
        roofline=dataclasses.asdict(audit) if audit else None,
        backward_baseline_ms=bwd_base.mean_ms, coo_ms=coo_ms,
        fused_mask_ms=fused_ms)


def measure_fused_mask(csr: CSRGraph, dim: int = DIM_ORIGIN,
                       ks: Sequence[int] = DEFAULT_KS, seed: int = 123,
                       log=print, device=None) -> dict:
    """Measure ONLY the mask-route fused forward for one graph (k -> ms).

    Targeted augmentation of an existing suite record (kernel_bench
    --fill-fused-mask): reproduces benchmark_graph's operand construction
    (same seed discipline — vals drawn before x) without re-measuring the
    other columns.
    """
    from maxk_tpu_torch.ops.cuda_topk import maxk_forward
    from maxk_tpu_torch.ops.spmm import spmm

    dev = resolve_device(device)
    csr, x, _ = _operands(csr, dim, seed)
    g = DeviceCSR.from_csr(csr, dev)
    xt = torch.from_numpy(x).to(dev)
    out = {}
    for k in ks:
        fm = time_fn(lambda: spmm(g, maxk_forward(xt, k)[0]), warmup=4,
                     runs=4)
        out[k] = fm.mean_ms
        log(f"0 fused_mask {dim} {k} maxk_fused_mask {fm.mean_ms:.4f}")
    return out


def measure_coo(csr: CSRGraph, dim: int = DIM_ORIGIN, seed: int = 123,
                log=print, device=None) -> float:
    """Measure ONLY the COO SpMM comparator for one graph (ms).

    Targeted augmentation of an existing suite record (kernel_bench
    --fill-coo): reproduces benchmark_graph's operand construction (same
    seed discipline — vals drawn before x) without re-measuring the
    other columns. Parity record for the reference's cuSPARSE COO path
    (kernels/spmm_cusparse.cu:65-119).
    """
    from maxk_tpu_torch.ops.spmm import spmm_coo

    dev = resolve_device(device)
    csr, x, _ = _operands(csr, dim, seed)
    xt = torch.from_numpy(x).to(dev)
    rows_t, cols_t, vals_t = _coo_operands(csr, dev)
    coo = time_fn(lambda: spmm_coo(rows_t, cols_t, vals_t, xt, csr.n_nodes),
                  warmup=2, runs=2)
    log(f"0 coo {dim} {dim} coo_spmm {coo.mean_ms:.4f}")
    return coo.mean_ms


def analyze_speedups(results: Sequence[GraphBenchResult],
                     min_degree: float = 50.0, log=print) -> dict:
    """Geomean per-k forward AND backward speedups over the dense
    baselines for avg-degree>min_degree graphs, vs the paper's published
    table (reference main_runner_direct.py:138-213; the published
    numbers are the backward SSpMM's — README.md:136).

    Returns {"forward": {k: geomean}, "backward": {k: geomean}}."""
    high = [r for r in results if r.avg_degree > min_degree and r.forward_ms]
    log(f"\nSpeedup analysis: {len(high)}/{len(results)} graphs with "
        f"avg degree > {min_degree:g}")
    if not high:
        return {}

    ks = sorted({k for r in high for k in r.forward_ms})
    header = ("graph            | avg_deg | " + " | ".join(
        f"fwd k={k:<3d}" for k in ks) + " | " + " | ".join(
        f"bwd k={k:<3d}" for k in ks))
    log(header)
    log("-" * len(header))
    fwd_k = {k: [] for k in ks}
    bwd_k = {k: [] for k in ks}
    for r in high:
        cells = []
        for k in ks:
            s = r.speedup(k)
            cells.append(f"{s:8.2f}" if s else "    -   ")
            if s:
                fwd_k[k].append(s)
        for k in ks:
            b = r.backward_speedup(k)
            cells.append(f"{b:8.2f}" if b else "    -   ")
            if b:
                bwd_k[k].append(b)
        log(f"{r.graph:<16s} | {r.avg_degree:7.1f} | " + " | ".join(cells))

    def _geomean(xs):
        return math.exp(sum(math.log(s) for s in xs) / len(xs))

    summary = {"forward": {}, "backward": {}}
    log("-" * len(header))
    for k in ks:
        paper = PAPER_SPEEDUPS.get(k)
        extra = (f"  (paper A100 SSpMM vs cuSPARSE: {paper:.2f}x)"
                 if paper else "")
        if fwd_k[k]:
            gm = _geomean(fwd_k[k])
            summary["forward"][k] = gm
            log(f"geomean forward speedup k={k}: {gm:.2f}x{extra}")
        if bwd_k[k]:
            gm = _geomean(bwd_k[k])
            summary["backward"][k] = gm
            log(f"geomean backward speedup k={k}: {gm:.2f}x{extra}")
    return summary


def synthetic_suite(seed: int = 123,
                    large: bool = False) -> list[tuple[str, CSRGraph]]:
    """Stand-in suite when the 24-graph binary dumps are not on disk:
    seeded power-law graphs spanning the reference suite's degree range.

    large=True appends shapes from the top of the reference 24-graph
    range (reddit: V=233k avg-deg ~492; ogbn-products: V=2.4M avg-deg
    ~51 — kernels/main.cu suite). These take minutes to generate on the
    host — opt-in via kernel_bench --large.
    """
    from maxk_tpu_torch.data.loaders import synthetic_graph
    specs = list(SUITE_SPECS) + (list(LARGE_SPECS) if large else [])
    return [(n, synthetic_graph(v, d, seed=seed)) for n, v, d in specs]


# (name, n_nodes, pre-symmetrization avg degree). The standard suite spans
# the reference 24-graph degree range plus the two small training-dataset
# shapes (flickr: V=89k avg-deg ~10; ogbn-proteins: V=132k avg-deg ~300).
SUITE_SPECS = (
    ("syn_small_d8", 8192, 8.0), ("syn_small_d64", 8192, 64.0),
    ("syn_mid_d16", 65536, 16.0), ("syn_mid_d64", 65536, 64.0),
    ("syn_mid_d128", 65536, 128.0), ("syn_big_d32", 262144, 32.0),
    ("syn_big_d100", 131072, 100.0),
    ("syn_flickr_shape", 89250, 5.0),
    ("syn_proteins_shape", 132534, 150.0),
)
LARGE_SPECS = (
    ("syn_yelp_shape", 716847, 9.8),        # E ~ 14M
    ("syn_reddit_shape", 232965, 246.0),    # E ~ 115M after sym
    ("syn_products_shape", 2449029, 25.5),  # E ~ 124M after sym
)

# Shape stand-ins for the reference's full 24-graph benchmark suite
# (README.md:72 — the name list ships only as images/24graphs.png, absent
# from the snapshot; these are the standard GNNAdvisor/TC-GNN evaluation
# graphs the MaxK-GNN paper benchmarks, with V and pre-symmetrization
# average degree taken from the datasets' published statistics). Same
# seeded power-law generator as the rest of the suite — these match the
# reference graphs in scale and sparsity pattern class, not exact
# topology. Opt-in via kernel_bench --suite24.
SUITE24_SPECS = (
    ("s24_cora", 2708, 4.0),
    ("s24_citeseer", 3327, 2.8),
    ("s24_pubmed", 19717, 4.5),
    ("s24_ppi", 56944, 14.4),
    ("s24_proteins_full", 43466, 3.7),
    ("s24_artist", 50515, 32.4),
    ("s24_flickr", 89250, 10.1),
    ("s24_blogcatalog", 88784, 23.6),
    ("s24_ogbn_proteins", 132534, 150.0),
    ("s24_ogbn_arxiv", 169343, 6.9),
    ("s24_reddit", 232965, 246.0),
    ("s24_dd", 334925, 5.0),
    ("s24_com_amazon", 334863, 5.5),
    ("s24_amazon0601", 403394, 8.4),
    ("s24_amazon0505", 410236, 11.9),
    ("s24_twitter_partial", 580768, 2.5),
    ("s24_web_berkstan", 685230, 11.1),
    ("s24_yelp", 716847, 9.8),
    ("s24_soc_pokec", 1632803, 18.8),
    ("s24_yeast", 1714644, 2.1),
    ("s24_ovcar_8h", 1890931, 2.1),
    ("s24_sw_620h", 1889971, 2.1),
    ("s24_ogbn_products", 2449029, 25.5),
    ("s24_yeasth", 3139988, 2.1),
)


def _gen_cached(gen, gen_name: str, name: str, v: int, d: float,
                seed: int):
    """Generate one suite graph, caching giant structures on disk.

    Multi-million-node synthetic generation costs minutes per graph.
    Structure-only cache (indptr/indices — benchmark values are redrawn
    per run) keyed by (name, generator, v, d, seed) under MAXK_GRAPH_CACHE
    (default: maxk_graph_cache in the temporary directory), in files named
    ``torch_...``: a retuned spec regenerates its graph, and the JAX
    package's files in the same directory are never read. Graphs small in
    BOTH nodes and edges regenerate in seconds and skip the cache (reddit
    is node-small but edge-huge).
    """
    if v < 500_000 and v * d < 20_000_000:
        return gen(v, d, seed=seed)
    cache_dir = os.environ.get(
        "MAXK_GRAPH_CACHE", os.path.join(tempfile.gettempdir(),
                                         "maxk_graph_cache"))
    path = os.path.join(cache_dir,
                        f"torch_{name}@{gen_name}_v{v}_d{d!r}_s{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return CSRGraph(z["indptr"], z["indices"])
    csr = gen(v, d, seed=seed)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:     # file object: savez must not
            np.savez(f, indptr=csr.indptr, indices=csr.indices)  # append .npz
        os.replace(tmp, path)
    except OSError:
        pass                      # cache is best-effort (disk full etc.)
    return csr


def suite24(seed: int = 123, skip=(), generator: str = "power"):
    """The 24-graph shape-stand-in suite (see SUITE24_SPECS), smallest
    first so partial runs cover the cheap graphs first. Lazily generated
    (one multi-million-node graph in host memory at a time); names in
    `skip` are not generated at all (kernel_bench --resume-json).
    generator='rmat' re-runs the shapes under R-MAT topology; names get
    an '@rmat' suffix so the records are distinguishable from the
    power-law rows."""
    from maxk_tpu_torch.data.loaders import rmat_graph, synthetic_graph
    gen = {"power": synthetic_graph, "rmat": rmat_graph}[generator]
    suffix = "" if generator == "power" else f"@{generator}"
    for n, v, d in SUITE24_SPECS:
        if n + suffix in skip:
            continue
        yield n + suffix, _gen_cached(gen, generator, n, v, d, seed)


def synthetic_by_name(name: str, seed: int = 123,
                      generator: str = "power"):
    """Generate ONE suite graph by name (targeted reruns) or None.

    generator: 'power' = the seeded uniform power-law stand-in (default,
    the recorded suite); 'rmat' = R-MAT at the same (V, degree) — a
    structurally distinct topology used to bound the stand-ins'
    topology-sensitivity (data/loaders.py rmat_graph)."""
    from maxk_tpu_torch.data.loaders import rmat_graph, synthetic_graph
    gen = {"power": synthetic_graph, "rmat": rmat_graph}[generator]
    for n, v, d in SUITE_SPECS + LARGE_SPECS + SUITE24_SPECS:
        if n == name:
            return _gen_cached(gen, generator, n, v, d, seed)
    return None
