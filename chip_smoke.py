#!/usr/bin/env python
"""Drive maxk_tpu_torch's main path on one CUDA card and check it.

  python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
  1 card      nvidia-smi name and power limit, torch's device name
  2 build     nvcc of every kernel (all at once), registers and spills
  3 K1        MaxK kernel vs its plain version, bit-equal
  4 K2        CSR SpMM kernel vs its plain version; vs torch.sparse
  5 spgemm    maxk_spgemm forward and dx vs the plain composition
  6 train     SAGE 4x256, k=32, bf16 compute, on the 131072-node
              synthetic graph: 5 steps and one eval; launch counts
  7 accuracy  the golden synthetic recipe's mean best_test over 16
              init seeds vs 0.9847
  8 kernels   per kernel: launches in phase 6, max error, times, bound;
              K2 on a graph of the same V and E without hubs; the share
              of the train step the kernels take
The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero before printing any result.
"""

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Golden synthetic recipe: SAGE maxk k=32 best_test (BASELINE.md), and
# the init seeds whose mean is held to it.
GOLDEN_BEST_TEST, GOLDEN_TOL = 0.9847, 0.02
GOLDEN_SEEDS = tuple(range(97, 113))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def torch_sparse(g):
    """The graph as a torch CSR tensor (the cuSPARSE yardstick). Both
    index arrays int64: torch accepts mixed index types unchecked and
    cuSPARSE then faults. (Its invariant check stays off: it would also
    demand sorted, distinct columns per row, which an SpMM does not
    need and this multigraph does not have.)"""
    return torch.sparse_csr_tensor(g.indptr, g.indices.long(), g.values,
                                   size=(g.n_nodes, g.n_nodes),
                                   check_invariants=False)


def sum_error_ratio(out, ref, g, x_abs) -> float:
    """max |out - ref| / bound, where bound_r = 2 * n_r * 2**-24 *
    sum_e |v_e| |x[c_e]| is the worst-case float32 error between two
    summation orders of row r's n_r terms. Hub rows (n_r ~ 1e5) make a
    fixed rtol meaningless; <= 1 is agreement."""
    from maxk_tpu_torch.ops.cuda_spmm import spmm_csr_plain
    from maxk_tpu_torch.ops.graph import DeviceCSR
    g_abs = DeviceCSR(g.indptr, g.indices, g.values.abs(), g.n_nodes)
    n = torch.diff(g.indptr).to(torch.float32)[:, None]
    bound = 2 * n * 2.0 ** -24 * spmm_csr_plain(g_abs, x_abs)
    diff = (out - ref).abs()
    return float((diff / bound.clamp_min(1e-30)).max())


def ptxas_summary(report: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] from ptxas -v."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out.append({"kernel": name})
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Full float32 in every reference product.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from maxk_tpu_torch.data.loaders import synthetic_graph
    from maxk_tpu_torch.data.datasets import Dataset, make_synthetic_dataset
    from maxk_tpu_torch.models.models import GraphBundle
    from maxk_tpu_torch.native.build import build_all
    from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
    from maxk_tpu_torch.ops.cuda_topk import (maxk_forward,
                                              maxk_forward_plain)
    from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm
    from maxk_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1 card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2 build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build_all()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         kernels={name: {"build_seconds": round(b["seconds"], 3),
                         "ptxas": ptxas_summary(b["ptxas"])}
                  for name, b in built.items()})

    # -- 3 K1 vs plain -----------------------------------------------------
    v, d = 131072, 256
    x_full = torch.randn(v, d, device=dev, generator=gen)
    cases = [("normal", x_full, k) for k in (1, 8, 32, 64, 256)]
    cases.append(("ties", torch.randint(-3, 4, (v, d), device=dev,
                                        generator=gen).float(), 32))
    cases.append(("odd_d200", torch.randn(v, 200, device=dev,
                                          generator=gen), 32))
    k1_err = 0.0
    for name, x, k in cases:
        y, mask = maxk_forward(x, k)
        y_ref, m_ref = maxk_forward_plain(x, k)
        check(torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
              and torch.equal(mask, m_ref),
              f"K1 differs from its plain version: {name} k={k}")
        k1_err = max(k1_err, float((y - y_ref).abs().max()))
    emit("k1", cases=[f"{n}:k={k}:{tuple(x.shape)}" for n, x, k in cases],
         bit_equal=True, max_abs_err=k1_err)
    del cases

    # -- 4 K2 vs plain, and vs torch.sparse --------------------------------
    rng = np.random.default_rng(1)
    n_small = 16384
    src = rng.integers(0, n_small, 20 * n_small)
    src = src[src % 4 != 0]                               # zero-degree rows
    dst = np.minimum((n_small * rng.power(0.3, len(src))).astype(np.int64),
                     n_small - 1)
    small = DeviceCSR.from_csr(CSRGraph.from_coo(
        src, dst.astype(np.int32), n_small,
        rng.uniform(size=len(src)).astype(np.float32)), dev)
    xs = torch.randn(n_small, d, device=dev, generator=gen)
    out32 = spmm_csr(small, xs)
    ref32 = spmm_csr_plain(small, xs)
    torch.testing.assert_close(out32, ref32, rtol=1e-5, atol=1e-5)
    check(bool(torch.all(out32[torch.diff(small.indptr) == 0] == 0)),
          "K2 wrote non-zero zero-degree rows")
    xs16 = xs.to(torch.bfloat16)
    mae16 = float((spmm_csr(small, xs16)
                   - spmm_csr_plain(small, xs16)).abs().mean())
    check(mae16 < 1e-3, f"K2 bf16 mean error {mae16} >= 1e-3")

    t0 = time.perf_counter()
    csr = synthetic_graph(v, 50.0, seed=123)
    graph_s = time.perf_counter() - t0
    g_mean_csr = csr.normalize("mean")
    g = DeviceCSR.from_csr(g_mean_csr, dev)
    out_full = spmm_csr(g, x_full)
    torch.cuda.synchronize()
    lib_full = torch.sparse.mm(torch_sparse(g), x_full)
    torch.testing.assert_close(out_full, lib_full, rtol=1e-5, atol=1e-5)
    x16 = x_full.to(torch.bfloat16)
    k2_err = float((spmm_csr(g, x16) - spmm_csr_plain(g, x16)).abs().max())
    check(k2_err < 1e-4, f"K2 full-size bf16 max error {k2_err}")
    deg = np.diff(csr.indptr)
    emit("k2", small_graph={"V": n_small, "E": small.n_edges,
                            "zero_degree_rows": int(
                                (torch.diff(small.indptr) == 0).sum())},
         f32_rtol=1e-5, bf16_mean_abs_err=mae16,
         full_graph={"V": v, "E": csr.n_edges, "max_degree": int(deg.max()),
                     "build_seconds": round(graph_s, 3)},
         vs_torch_sparse_f32="allclose rtol=1e-5 atol=1e-5",
         max_abs_err_full_bf16=k2_err)

    # -- 5 maxk_spgemm vs the plain composition ----------------------------
    bundle = GraphBundle.from_csr(csr, norms=("mean",), symmetric=True,
                                  device=dev)
    xg = x_full.clone().requires_grad_(True)
    dy = torch.randn(v, d, device=dev, generator=gen)
    y = maxk_spgemm(bundle.g_mean, bundle.g_mean_t, xg, 32)
    y.backward(dy)
    y_s, mask = maxk_forward_plain(x_full, 32)
    y_ref = spmm_csr_plain(bundle.g_mean, y_s.to(torch.bfloat16))
    dx_ref = spmm_csr_plain(bundle.g_mean_t, dy.to(torch.bfloat16)) * mask
    y_ratio = sum_error_ratio(y.detach(), y_ref, bundle.g_mean,
                              y_s.to(torch.bfloat16).float().abs())
    dx_ratio = sum_error_ratio(xg.grad, dx_ref, bundle.g_mean_t,
                               dy.to(torch.bfloat16).float().abs())
    check(y_ratio <= 1.0 and dx_ratio <= 1.0,
          f"maxk_spgemm off its plain composition: error/bound "
          f"y {y_ratio}, dx {dx_ratio}")
    emit("spgemm", shape=[v, d], k=32, compute_dtype="bfloat16",
         y_max_abs_err=float((y.detach() - y_ref).abs().max()),
         dx_max_abs_err=float((xg.grad - dx_ref).abs().max()),
         y_err_over_sum_bound=y_ratio, dx_err_over_sum_bound=dx_ratio)
    del xg, y, dy, y_s, mask, y_ref, dx_ref

    # -- 6 full-width training ---------------------------------------------
    # The dataset of bench.py: features and split drawn after the (unused)
    # edge values from one seed-123 stream; unit edge values, symmetric.
    rng = np.random.default_rng(123)
    rng.uniform(0, 1, csr.n_edges)
    feats = rng.uniform(0, 1, (v, d)).astype(np.float32)
    ds = Dataset(
        name="bench", csr=csr.with_values(np.ones(csr.n_edges, np.float32)),
        features=feats, labels=rng.integers(0, 41, size=v),
        train_mask=rng.uniform(size=v) < 0.66,
        val_mask=rng.uniform(size=v) < 0.1,
        test_mask=rng.uniform(size=v) < 0.2,
        num_classes=41, multilabel=False, metric="micro_f1", symmetric=True)
    n_layers = 4
    cfg = types.SimpleNamespace(
        model="sage", hidden_dim=256, hidden_layers=n_layers, maxk=32,
        dropout=0.5, norm=True, nonlinear="maxk", w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=97,
        compute_dtype="bfloat16", device="cuda")
    trainer = Trainer(cfg, ds, graphs=bundle)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    maxk_forward.launches = 0
    spmm_csr.launches = 0
    steps = []
    for _ in range(5):
        k1_before, k2_before = maxk_forward.launches, spmm_csr.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.train_step()
        end.record()
        end.synchronize()
        steps.append(dict(ms=start.elapsed_time(end), loss=float(loss),
                          k1=maxk_forward.launches - k1_before,
                          k2=spmm_csr.launches - k2_before))
    logits = trainer.eval_logits()
    torch.cuda.synchronize()
    launches = {"k1": maxk_forward.launches, "k2": spmm_csr.launches}
    for s in steps:
        check(math.isfinite(s["loss"]), f"non-finite loss {s['loss']}")
        check(s["k2"] == 2 * n_layers,
              f"K2 launches per step {s['k2']} != {2 * n_layers}")
        check(s["k1"] >= n_layers, f"K1 launches per step {s['k1']}")
    check(tuple(logits.shape) == (v, 41)
          and bool(torch.isfinite(logits).all()), "bad eval logits")
    median_step_ms = statistics.median(s["ms"] for s in steps)
    emit("train", config="sage 4x256 maxk k=32 norm dropout=0.5 bf16",
         V=v, E=csr.n_edges, steps=steps, median_step_ms=median_step_ms,
         launches=launches,
         peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    del trainer, logits

    # -- 7 golden accuracy ---------------------------------------------------
    # The golden figure is one draw: one init seed under flax's init and
    # JAX's dropout bits. torch's init and the card's dropout bits draw
    # other numbers from the same seed, and best_test moves by about a
    # point from seed to seed, so the mean over GOLDEN_SEEDS is held to
    # the band; each seed and the spread are printed.
    gds = make_synthetic_dataset(n_nodes=4096, avg_degree=16.0,
                                 n_classes=12, in_size=64, seed=97,
                                 feature_noise=4.0, rewire_p=0.7,
                                 train_frac=0.05)
    t0 = time.perf_counter()
    runs = []
    for seed in GOLDEN_SEEDS:
        with tempfile.TemporaryDirectory() as tmp:
            gcfg = types.SimpleNamespace(
                model="sage", hidden_dim=64, hidden_layers=3, dropout=0.2,
                norm=True, nonlinear="maxk", maxk=32, epochs=150, w_lr=0.01,
                w_weight_decay=0.0, enable_lookahead=False, seed=seed,
                path=tmp, log_every=1000, eval_every=5, save_every=0,
                resume=False, timing=False, patience=10,
                compute_dtype="float32", device="cuda")
            res = Trainer(gcfg, gds).fit()
        runs.append(dict(seed=seed, best_val=res.best_val,
                         best_test=res.best_test, best_epoch=res.best_epoch,
                         epochs_run=res.epochs_run))
    tests = [r["best_test"] for r in runs]
    mean_test = statistics.mean(tests)
    gap = mean_test - GOLDEN_BEST_TEST
    emit("accuracy", runs=runs, mean_best_test=mean_test,
         std_best_test=statistics.stdev(tests),
         golden_best_test=GOLDEN_BEST_TEST, gap=gap, tolerance=GOLDEN_TOL,
         seconds=round(time.perf_counter() - t0, 3))
    check(abs(gap) <= GOLDEN_TOL,
          f"golden mean best_test {mean_test:.4f} is {gap:+.4f} from "
          f"{GOLDEN_BEST_TEST}")

    # -- 8 kernel line -------------------------------------------------------
    k = 32
    k1_ms = time_ms(lambda: maxk_forward(x_full, k))
    k1_plain = time_ms(lambda: maxk_forward_plain(x_full, k), 1, 5)

    def topk_scatter():
        vals, idx = torch.topk(x_full, k, dim=1)
        return torch.zeros_like(x_full).scatter_(1, idx, vals)

    k1_lib = time_ms(topk_scatter)
    k1_bound, k1_by = bound_ms(v * d * (4 + 4 + 1), 33 * v * d)

    e = g.n_edges
    k2_ms = time_ms(lambda: spmm_csr(g, x16))
    k2_plain = time_ms(lambda: spmm_csr_plain(g, x16), 1, 5)
    x16_as_f32 = x16.float()
    sparse = torch_sparse(g)
    k2_lib = time_ms(lambda: torch.sparse.mm(sparse, x16_as_f32))
    k2_bound, k2_by = bound_ms(
        v * d * 2 + e * 4 + e * 4 + (v + 1) * 8 + v * d * 4, 2 * e * d)

    # What the hub rows cost: the same V and E with uniform degrees.
    uni_csr = synthetic_graph(v, 50.0, seed=123, power_law=False)
    uni = DeviceCSR.from_csr(uni_csr.normalize("mean"), dev)
    k2_uniform_ms = time_ms(lambda: spmm_csr(uni, x16))
    del uni

    # Share of the median train step that K1 and K2 take at these times.
    per_step = steps[-1]
    kernel_step_ms = per_step["k1"] * k1_ms + per_step["k2"] * k2_ms

    kernels = [
        {"name": "maxk_topk", "route": "cuda",
         "source": "maxk_tpu_torch/csrc/maxk_topk.cu",
         "replaces": "maxk_tpu/ops/pallas_topk.py:95",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib},
        {"name": "spmm_csr", "route": "cuda",
         "source": "maxk_tpu_torch/csrc/spmm_csr.cu",
         "replaces": "maxk_tpu/ops/pallas_spmm.py:73",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib},
    ]
    emit("kernels", shapes={"maxk_topk": f"x ({v}, {d}) f32, k={k}",
                            "spmm_csr": f"A {v}x{v} E={e} f32 values, "
                                        f"x ({v}, {d}) bf16"},
         notes="library: torch.topk+scatter_ (K1), torch.sparse.mm on "
               "the bf16-rounded x in f32 (K2)",
         spmm_csr_uniform={"E": uni_csr.n_edges,
                           "max_degree": int(uni_csr.out_degrees.max()),
                           "ms": k2_uniform_ms},
         step_kernels={"median_step_ms": median_step_ms,
                       "k1_ms": per_step["k1"] * k1_ms,
                       "k2_ms": per_step["k2"] * k2_ms,
                       "share": kernel_step_ms / median_step_ms})

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
