"""The port's kernels timed on one CUDA card, one JSON line a kernel: the
numbers of PERF.md's kernel table.

  python -m maxk_tpu_torch.bench.kernel_table

Each kernel runs at the cell: the mean-normalised 131,072-node synthetic
graph (``cell_csr``: ``synthetic_graph(131072, 50.0, seed=123)``, E =
13,107,200, with hubs), x of (131072, 256) float32 and k = 32; the wide
top-k kernel at (16384, 2048); GNN_res's BatchNorm passes at the
ogbn-products shape (2,449,029, 256). A line gives the kernel's ms, its
plain version's, a library's way to the same result and its bound:
``bound_ms`` is the larger of the bytes (each input read and each output
written once) at the H100's 3.35 TB/s and the operations at its 67
TFLOP/s float32 (``roofline.H100``), and ``bound_by`` says which. Beside
them: K2's gather rate and the gather probe's (``bench/roofline.py``),
K5's wavefront floor at the SM clock nvidia-smi sampled while K5 ran
(``k5_wavefronts``), and K7's values a clock an SM.

Times are ``bench/timing.py::time_fn``'s: 4 samples of 20 calls queued
behind a sleeping device, averaged; a plain version's one sample of 5
calls. The card (``harness.device_info``) and each kernel build's
seconds and ptxas registers come first.

The kernels' checks are the ``-m cuda`` tests (``tests/test_torch_cuda.py``
and ``tests/test_torch_card_*.py``), which also take the cell, the
dataset and the config from here, as do the A/B scripts at the repo root.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

from maxk_tpu_torch.bench.roofline import H100
from maxk_tpu_torch.bench.timing import time_fn

V, D, K = 131072, 256, 32
WIDE_SHAPE = (16384, 2048)
BN_SHAPE = (2_449_029, 256)
SMS = 132


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(n_bytes: float, n_ops: float):
    """(ms, "bytes" or "operations"): the larger of the two at the
    H100's peaks."""
    t_bytes = n_bytes / H100["hbm_bytes_per_s"] * 1e3
    t_ops = n_ops / H100["fp32_flops_per_s"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def descent_steps(x: torch.Tensor, k: int) -> torch.Tensor:
    """Steps each row of x runs in K1's descent, by the closed form
    32 - floor(log2(key_k ^ key_k+1)) of its k-th and (k+1)-th largest
    sortable keys (torch.topk): 32 when they are equal, 0 when k = D."""
    from maxk_tpu_torch.ops.cuda_topk import sortable_key
    if k == x.shape[1]:
        return torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    top = torch.topk(sortable_key(x), k + 1, dim=1).values
    xor = top[:, k - 1] ^ top[:, k]
    bit_length = sum(((xor >> b) > 0).long() for b in range(32))
    return torch.where(xor == 0, 32, 33 - bit_length)


def torch_sparse(g):
    """The graph as a torch CSR tensor (the cuSPARSE yardstick). Both
    index arrays int64: torch accepts mixed index types unchecked and
    cuSPARSE then faults. (Its invariant check stays off: it would also
    demand sorted, distinct columns per row, which an SpMM does not
    need and this multigraph does not have.)"""
    return torch.sparse_csr_tensor(g.indptr, g.indices.long(), g.values,
                                   size=(g.n_nodes, g.n_nodes),
                                   check_invariants=False)


def gathered_sectors(selector, d: int, elem_bytes: int) -> int:
    """Distinct 32-byte sectors of a row-major (V, d) matrix that a
    gather at ascending per-row selectors touches."""
    rows = torch.arange(selector.shape[0], device=selector.device)[:, None]
    sectors = ((rows * d + selector.long()) * elem_bytes // 32).flatten()
    return int(torch.unique_consecutive(sectors).numel())


@contextlib.contextmanager
def sm_clock():
    """The SM clock (MHz) nvidia-smi reports every 50 ms while the block
    runs, and once just before it: yields a list that holds the samples
    after it."""
    samples = []
    proc = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        # The first sample, so that a short block has one.
        first = proc.stdout.readline()
        yield samples
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        samples.extend(float(t) for t in (first + out).split()
                       if t.isdigit())
        check(len(samples) > 0, "nvidia-smi gave no SM clock sample")


def values_per_clock(values: int, ms: float, mhz: list) -> dict:
    """K7's values (edges times columns) a clock an SM: over the time,
    132 SMs and the median SM clock nvidia-smi sampled."""
    clock = statistics.median(mhz)
    return {"values": values, "sm_clock_mhz": clock,
            "clock_samples": len(mhz),
            "per_clock_per_sm": values / (ms * 1e-3) / (SMS * clock * 1e6)}


def k5_wavefronts(g, selector, k: int, value_bytes: int,
                  sm_mhz: float) -> dict:
    """K5's L1 data-stage wavefronts an edge, counted from the data for
    the kernel's schedule (csrc/spgemm_cbsr.cu), and the floor they set:
    E * total / 132 SMs at one wavefront a clock at `sm_mhz`.
    - scatter: a shared-memory load and store per access; an access
      covers one edge of each of the warp's segments (items of the
      plan's work list, step by step) and entries c*L .. c*L + L - 1 of
      it, and takes as many wavefronts as the most lanes on one bank;
    - staging: the 16-byte reads of the staged columns and values (two
      every 4 steps), and the fill (two 128-byte loads and two shared
      stores per 32 steps and segment);
    - records: the 128-byte lines each load of a table row touches: a
      (bf16 << 16 | selector) record row of 4k bytes, or with float32
      values a values row of 4k bytes and a selector row of k;
    - flush: the row's shared read and zeroing and its global store.
    Not measured on the device."""
    plan, dev = g.plan, selector.device
    v, d = selector.shape[0], 256
    # Lanes a segment takes: 8 at k <= 8 (four segments a warp), 16 at
    # k <= 16 (two), else the warp's 32.
    lanes = 8 if k <= 8 else 16 if k <= 16 else 32
    per = 32 // lanes
    work = plan.work
    start, n = work[:, 0], (work[:, 1] >> 32)
    e, n_seg = g.n_edges, plan.n_segments
    in_degree = torch.bincount(g.indices.long(), minlength=v).double()
    # Bank histogram of each row's entries, one per access c.
    hist = []
    for c in range(0, k, lanes):
        banks = selector[:, c:c + lanes].long() % 32
        hist.append(torch.zeros(v, 32, device=dev).scatter_add_(
            1, banks, torch.ones_like(banks, dtype=torch.float32)))
    n_items = (n_seg + per - 1) // per
    steps = n[torch.arange(n_items, device=dev) * per]
    item = torch.repeat_interleave(torch.arange(n_items, device=dev), steps)
    step = (torch.arange(item.shape[0], device=dev)
            - (torch.cumsum(steps, 0) - steps)[item])
    scatter = 0.0
    for lo in range(0, item.shape[0], 1 << 21):
        it, j = item[lo:lo + (1 << 21)], step[lo:lo + (1 << 21)]
        rows = []
        for p in range(per):
            s = it * per + p
            ok = s < n_seg
            s = torch.where(ok, s, 0)
            ok &= j < n[s]
            rows.append((ok, g.indices[torch.where(ok, start[s] + j,
                                                   0)].long()))
        for h in hist:
            # Segment p's row sits p * d floats along: its banks shift.
            total = sum(torch.where(ok[:, None],
                                    h[r].roll(p * d % 32, dims=1), 0.0)
                        for p, (ok, r) in enumerate(rows))
            scatter += 2 * float(total.max(dim=1).values.sum())
    chunks = float(((steps + 31) // 32).sum())
    staging = 2 * float(((steps + 3) // 4).sum()) + 4 * per * chunks
    lines = 0.0
    rows = torch.arange(v, device=dev, dtype=torch.float64)
    for rb in ((4,) if value_bytes == 2 else (4, 1)):
        for c in range(0, k, lanes):
            first = rows * k * rb + c * rb
            last = first + min(lanes, k - c) * rb - 1
            lines += float((((last // 128) - (first // 128) + 1)
                            * in_degree).sum())
    flush = n_seg * 3 * d * 4 / 128
    model = {"lanes": lanes, "segments_a_warp": per,
             "scatter": scatter / e, "staging": staging / e,
             "records": lines / e, "flush": flush / e}
    model["total"] = sum(model[x] for x in ("scatter", "staging",
                                            "records", "flush"))
    model["floor_ms"] = e * model["total"] / SMS / (sm_mhz * 1e3)
    model["sm_mhz"] = sm_mhz
    return model


def ptxas_summary(report: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] from ptxas -v."""
    out = []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"kernel": m.group(1)})
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
    return out


def sass_functions(lib: str, name: str) -> dict:
    """{heading: listing} of each kernel in the library `lib` whose
    mangled name holds `name`, from `cuobjdump -sass`."""
    from maxk_tpu_torch.native.build import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump failed on {lib}: {res.stderr}")
    return {f.splitlines()[0].strip(): f
            for f in res.stdout.split("Function : ")[1:]
            if name in f.splitlines()[0]}


def count_int_to_float(listing: str) -> int:
    """Int-to-float conversions (I2F*, I2FP*) in a SASS listing."""
    return len(re.findall(r"\bI2FP?(?=[.\s])", listing))


@functools.cache
def cell_csr():
    """The cell's graph on the host: 131,072 nodes, symmetric, power-law
    degrees with hubs, unit values (normalise before use)."""
    from maxk_tpu_torch.data.loaders import synthetic_graph
    return synthetic_graph(V, 50.0, seed=123)


def bench_dataset(csr, v: int = V, d: int = D):
    """The dataset of bench.py: features and split drawn after the
    (unused) edge values from one seed-123 stream; unit edge values,
    symmetric."""
    from maxk_tpu_torch.data.datasets import Dataset
    rng = np.random.default_rng(123)
    rng.uniform(0, 1, csr.n_edges)
    feats = rng.uniform(0, 1, (v, d)).astype(np.float32)
    return Dataset(
        name="bench", csr=csr.with_values(np.ones(csr.n_edges, np.float32)),
        features=feats, labels=rng.integers(0, 41, size=v),
        train_mask=rng.uniform(size=v) < 0.66,
        val_mask=rng.uniform(size=v) < 0.1,
        test_mask=rng.uniform(size=v) < 0.2,
        num_classes=41, multilabel=False, metric="micro_f1", symmetric=True)


def train_config(n_layers: int = 4):
    """Full-width SAGE n_layers x 256, MaxK k=32, bf16 compute, seed 97."""
    return types.SimpleNamespace(
        model="sage", hidden_dim=256, hidden_layers=n_layers, maxk=K,
        dropout=0.5, norm=True, nonlinear="maxk", w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=97,
        compute_dtype="bfloat16", device="cuda")


def layer_inputs(cfg, ds, bundle) -> list:
    """The x that MaxK receives in each hidden layer during the first train
    step of a fresh Trainer(cfg), recorded from that step (``models.maxk``
    wrapped while it runs). On the CBSR route K4 takes the same x."""
    from maxk_tpu_torch.models import models
    from maxk_tpu_torch.train.loop import Trainer
    trainer = Trainer(cfg, ds, graphs=bundle)
    real, xs = models.maxk, []

    def record(x, k):
        xs.append(x.detach().clone())
        return real(x, k)

    models.maxk = record
    try:
        trainer.train_step()
    finally:
        models.maxk = real
    return xs


def _kernel(name: str, shape: str, fn, plain, library: str, lib_fn,
            n_bytes: float, n_ops: float, **extra) -> float:
    """Time fn, its plain version and lib_fn (None: no library line);
    print the kernel's line; return fn's ms."""
    ms = time_fn(fn).mean_ms
    bound, by = bound_ms(n_bytes, n_ops)
    emit("kernel", kernel=name, shape=shape, ms=ms,
         plain_ms=time_fn(plain, warmup=1, runs=1, calls=5).mean_ms,
         library=library,
         library_ms=None if lib_fn is None else time_fn(lib_fn).mean_ms,
         bound_ms=bound, bound_by=by, share_of_bound=bound / ms, **extra)
    return ms


def _topk_kernels(x: torch.Tensor, names: tuple, shape: str) -> None:
    """K1's and K4's lines (or the wide kernel's two entries) on x at
    k = K. Bytes: x read once, and y and mask (K1) or k values and
    selectors (K4) written once; operations: a compare and an add per
    element and descent step on this x, and one compare for the ties."""
    from maxk_tpu_torch.ops.cuda_topk import (cbsr_topk_forward,
                                              cbsr_topk_plain, maxk_forward,
                                              maxk_forward_plain)
    v, d = x.shape
    steps = float(descent_steps(x, K).double().mean())
    n_ops = (2 * steps + 1) * v * d

    def topk_scatter():
        vals, idx = torch.topk(x, K, dim=1)
        return torch.zeros_like(x).scatter_(1, idx, vals)

    def topk_sorted():
        vals, idx = torch.topk(x, K, dim=1, sorted=False)
        sel, order = idx.sort(dim=1)
        return vals.gather(1, order), sel

    _kernel(names[0], shape, lambda: maxk_forward(x, K),
            lambda: maxk_forward_plain(x, K), "torch.topk + scatter_",
            topk_scatter, v * d * (4 + 4 + 1), n_ops,
            mean_descent_steps=steps)
    _kernel(names[1], shape, lambda: cbsr_topk_forward(x, K),
            lambda: cbsr_topk_plain(x, K), "torch.topk + sort + gather",
            topk_sorted, v * d * 4 + v * K * (4 + 4), n_ops,
            mean_descent_steps=steps)


def _batchnorm_kernels(gen) -> None:
    """BatchNorm's four passes at BN_SHAPE on randn x and dy, every row
    valid. Bytes, float32: x read (sums forward), dy and x read (sums
    backward), x read and y written (affine), dy and x read and dx
    written (dx)."""
    from maxk_tpu_torch.ops.cuda_batchnorm import (bn_affine,
                                                   bn_affine_plain, bn_dx,
                                                   bn_dx_plain, bn_sums,
                                                   bn_sums_plain)
    v, d = BN_SHAPE
    dev = gen.device
    x = torch.randn(v, d, device=dev, generator=gen) * 2.0 + 0.5
    dy = torch.randn(v, d, device=dev, generator=gen)
    w = torch.rand(d, device=dev, generator=gen) + 0.5
    b = torch.randn(d, device=dev, generator=gen)
    s1, s2 = bn_sums(x)
    mean = s1 / v
    rstd = torch.rsqrt(torch.clamp(s2 / v - mean * mean, min=0.0) + 1e-5)
    scale = rstd * w
    q1, q2 = bn_sums(dy, norm=(x, mean, rstd))
    c_dy, c_dyx = -scale * (q1 / v), -scale * (q2 / v)
    shape, n = f"({v}, {d}) float32", v * d * 4
    _kernel("BN sums", shape, lambda: bn_sums(x), lambda: bn_sums_plain(x),
            "torch.var_mean",
            lambda: torch.var_mean(x, dim=0, correction=0), n, 3 * v * d)
    _kernel("BN sums backward", shape,
            lambda: bn_sums(dy, norm=(x, mean, rstd)),
            lambda: bn_sums_plain(dy, norm=(x, mean, rstd)), None, None,
            2 * n, 5 * v * d)
    _kernel("BN affine", shape, lambda: bn_affine(x, mean, scale, b),
            lambda: bn_affine_plain(x, mean, scale, b), None, None, 2 * n,
            3 * v * d)
    _kernel("BN dx", shape,
            lambda: bn_dx(dy, x, mean, rstd, scale, c_dy, c_dyx),
            lambda: bn_dx_plain(dy, x, mean, rstd, scale, c_dy, c_dyx),
            None, None, 3 * n, 6 * v * d)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_table: no CUDA device", file=sys.stderr)
        return 1
    from maxk_tpu_torch.bench.harness import device_info
    from maxk_tpu_torch.bench.roofline import gather_probe
    from maxk_tpu_torch.native.build import build_all
    from maxk_tpu_torch.ops.cbsr import cbsr_expand
    from maxk_tpu_torch.ops.cuda_expand import (cbsr_expand_forward,
                                                cbsr_expand_int8,
                                                cbsr_expand_int8_plain,
                                                cbsr_expand_plain)
    from maxk_tpu_torch.ops.cuda_gather import (cbsr_gather_forward,
                                                cbsr_gather_plain)
    from maxk_tpu_torch.ops.cuda_spgemm_cbsr import (spgemm_cbsr_csr,
                                                     spgemm_cbsr_plain)
    from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
    from maxk_tpu_torch.ops.cuda_spmm_int8 import (SLAB, spmm_int8_csr,
                                                   spmm_int8_plain)
    from maxk_tpu_torch.ops.cuda_topk import cbsr_topk_forward
    from maxk_tpu_torch.ops.graph import DeviceCSR
    from maxk_tpu_torch.ops.spmm import quantize_columns

    dev = torch.device("cuda")
    emit("card", **device_info(dev), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    emit("build", kernels={name: {"seconds": round(b["seconds"], 3),
                                  "ptxas": ptxas_summary(b["ptxas"])}
                           for name, b in build_all().items()})
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(V, D, device=dev, generator=gen)
    x16 = x.to(torch.bfloat16)
    g = DeviceCSR.from_csr(cell_csr().normalize("mean"), dev)
    e, sparse = g.n_edges, torch_sparse(g)
    graph = f"A {V}x{V} with E={e}"

    _topk_kernels(x, ("K1", "K4"), f"x ({V}, {D}) float32, k={K}")

    # K2 on the bf16 operand a train step hands it; each edge pulls a
    # row of x through L2, as the gather probe does alone.
    x16_as_f32 = x16.float()
    ms = _kernel("K2", graph + f", x ({V}, {D}) bf16",
                 lambda: spmm_csr(g, x16),
                 lambda: spmm_csr_plain(g, x16),
                 "torch.sparse.mm on x in float32",
                 lambda: torch.sparse.mm(sparse, x16_as_f32),
                 V * D * 2 + e * 4 + e * 4 + (V + 1) * 8 + V * D * 4,
                 2 * e * D)
    probe_ms = time_fn(lambda: gather_probe(x16, g.indices, 4)).mean_ms
    emit("gather_rate", k2_bytes_per_s=e * D * 2 / (ms * 1e-3),
         probe_bytes_per_s=e * D * 2 / (probe_ms * 1e-3), probe_ms=probe_ms,
         model_gather_bytes_per_s=H100["gather_bytes_per_s"])
    del x16_as_f32

    values, selector = cbsr_topk_forward(x, K)
    sel_long = selector.long()
    _kernel("K3", f"dense ({V}, {D}) bf16, selectors ({V}, {K})",
            lambda: cbsr_gather_forward(x16, selector),
            lambda: cbsr_gather_plain(x16, selector),
            "torch.gather", lambda: torch.gather(x16, 1, sel_long),
            V * K * (4 + 2) + 32 * gathered_sectors(selector, D, 2), 0)

    vb, sel8 = values.to(torch.bfloat16), selector.to(torch.uint8)
    xe32 = cbsr_expand(vb, selector, D).float()
    _kernel("K5", graph + f", values ({V}, {K}) bf16, selectors uint8",
            lambda: spgemm_cbsr_csr(g, vb, sel8, D),
            lambda: spgemm_cbsr_plain(g, vb, sel8, D),
            "torch.sparse.mm on the expanded operand in float32",
            lambda: torch.sparse.mm(sparse, xe32),
            (V + 1) * 8 + e * (4 + 4) + V * K * (2 + 1) + V * D * 4,
            2 * e * K)
    with sm_clock() as mhz:
        k5_ms = time_fn(lambda: spgemm_cbsr_csr(g, vb, sel8, D)).mean_ms
    emit("k5_wavefronts", ms=k5_ms, **k5_wavefronts(
        g, sel8, K, 2, statistics.median(mhz)))
    del xe32, vb, sel8

    xw = torch.randn(*WIDE_SHAPE, device=dev, generator=gen)
    _topk_kernels(xw, ("K1 wide", "K4 wide"), f"x {WIDE_SHAPE}, k={K}")
    del xw

    rows = f"values ({V}, {K}) float32 into ({V}, {D})"
    _kernel("K6", rows, lambda: cbsr_expand_forward(values, selector, D),
            lambda: cbsr_expand_plain(values, selector, D),
            "zeros + scatter_",
            lambda: torch.zeros_like(x).scatter_(1, sel_long, values),
            V * K * (4 + 4) + V * D * 4, 0)
    _kernel("K6 int8", rows, lambda: cbsr_expand_int8(values, selector, D),
            lambda: cbsr_expand_int8_plain(values, selector, D), None, None,
            V * K * (4 + 4) + V * D + V * 4, 0)
    del values, selector, sel_long

    q, scale = quantize_columns(x)
    deq = q.float() * scale
    # The int8 table, its column scales, the CSR arrays and the float32
    # out, each moved once.
    _kernel("K7", graph + f", int8 x ({V}, {D}), column scale, "
            f"{SLAB}-column slab",
            lambda: spmm_int8_csr(g, q, scale, False),
            lambda: spmm_int8_plain(g, q, scale, False),
            "torch.sparse.mm on the dequantized table in float32",
            lambda: torch.sparse.mm(sparse, deq),
            V * D + D * 4 + (V + 1) * 8 + e * 8 + V * D * 4, 2 * e * D)
    with sm_clock() as mhz:
        k7_ms = time_fn(lambda: spmm_int8_csr(g, q, scale, False)).mean_ms
    emit("k7_values_per_clock", ms=k7_ms,
         **values_per_clock(e * D, k7_ms, mhz))
    del q, scale, deq, sparse, g, x, x16

    _batchnorm_kernels(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
