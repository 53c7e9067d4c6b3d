"""Headline benchmark — the port's counterpart of ``bench.py``: the MaxK
CBSR forward SpGEMM against the production dense SpMM baseline, on one
CUDA card by default.

  python -m maxk_tpu_torch.bench.headline [--device cpu] [--verbose]

vs_baseline answers "is MaxK aggregation faster than not using MaxK at
all": the baseline is ``spmm`` (K2 at bf16 compute) on the dense input,
the role cuSPARSE plays in the paper.

Prints exactly one JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "train_step_ms": N}

Graph: reddit from --graphs when the binary CSR suite is on disk
(reference wire format, kernels/graphs/), otherwise the seeded synthetic
power-law graph synthetic_graph(131072, 50.0, seed=123). Protocol: dim
256, k 32 (reference kernels/main.cu:52-54), 4 warmup + 4 timed samples
a kernel (spmm_base.h:58-74), 10+10 for the baseline
(spmm_cusparse.cu:35-51); bench/timing.py says what a sample is. Under
--verbose the other times go to stderr: the unfused plain SpMM
(spmm_csr_plain, torch ops), TopK->CBSR, the whole fused op and the
train step.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", default="./graphs",
                    help="dir with <name>.indptr/.indices binaries")
    ap.add_argument("--graph", default="reddit.dgl")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--n-nodes", type=int, default=131072,
                    help="synthetic fallback size")
    ap.add_argument("--avg-degree", type=float, default=50.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu for a smoke run)")
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from maxk_tpu_torch.bench.timing import time_fn
    from maxk_tpu_torch.data.datasets import Dataset
    from maxk_tpu_torch.data.loaders import (available_graphs,
                                             load_csr_binary,
                                             synthetic_graph)
    from maxk_tpu_torch.ops.cbsr import cbsr_topk
    from maxk_tpu_torch.ops.cuda_spmm import spmm_csr_plain
    from maxk_tpu_torch.ops.graph import DeviceCSR, resolve_device
    from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spgemm_forward_cbsr
    from maxk_tpu_torch.ops.spmm import spmm
    from maxk_tpu_torch.train.loop import Trainer

    dev = resolve_device(args.device)

    def log(*a):
        if args.verbose:
            print(*a, file=sys.stderr)

    names = available_graphs(args.graphs)
    stem = args.graph.removesuffix(".dgl")
    if args.graph in names or stem in names:
        name = args.graph if args.graph in names else stem
        csr = load_csr_binary(args.graphs, name)
        log(f"loaded {name}: V={csr.n_nodes} E={csr.n_edges}")
    else:
        csr = synthetic_graph(args.n_nodes, args.avg_degree, seed=123)
        log(f"synthetic graph: V={csr.n_nodes} E={csr.n_edges}")

    rng = np.random.default_rng(123)  # reference seeds features with 123
    vals = rng.uniform(0, 1, csr.n_edges).astype(np.float32)
    csr = csr.with_values(vals)
    x_np = rng.uniform(0, 1, (csr.n_nodes, args.dim)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)

    g = DeviceCSR.from_csr(csr, dev)
    gt = DeviceCSR.from_csr(csr.transpose(), dev)
    log(f"segments: {g.plan.n_segments} of <= {g.plan.seg_len} edges, "
        f"{g.plan.n_partials} partials rows")
    nnz = csr.n_edges

    # The production SpMM: THE baseline (10+10 protocol, the role
    # cuSPARSE plays in the reference benchmark).
    t_base = time_fn(lambda: spmm(g, x), warmup=10, runs=10)
    log(f"baseline spmm: {t_base.mean_ms:.4f} ms "
        f"({t_base.nnz_per_s(nnz)/1e9:.2f} Gnnz/s)")

    if args.verbose:
        # The unfused plain SpMM in torch ops (K2's plain version), for
        # the logs only; one call a sample.
        t_plain = time_fn(lambda: spmm_csr_plain(g, x), warmup=1, runs=2,
                          calls=1)
        log(f"unfused spmm_csr_plain: {t_plain.mean_ms:.4f} ms "
            f"({t_plain.nnz_per_s(nnz)/1e9:.2f} Gnnz/s)")

    # MaxK SpGEMM forward (the headline kernel). Reference protocol: the
    # CBSR operand is prepared beforehand and the TopK kernel is timed
    # separately (kernels/main.cu:120-146 builds the selector outside
    # do_test), so the headline times spgemm_forward_cbsr; the whole
    # fused op (TopK included) is logged alongside.
    v, s = cbsr_topk(x, args.k)
    t_topk = time_fn(lambda: cbsr_topk(x, args.k), warmup=4, runs=4)
    log(f"topk->cbsr k={args.k}: {t_topk.mean_ms:.4f} ms")
    t_fused = time_fn(lambda: spgemm_forward_cbsr(g, v, s, args.dim),
                      warmup=4, runs=4)
    t_full = time_fn(lambda: maxk_spgemm(g, gt, x, args.k), warmup=4,
                     runs=4)
    log(f"maxk spgemm fwd k={args.k}: {t_fused.mean_ms:.4f} ms "
        f"({t_fused.nnz_per_s(nnz)/1e9:.2f} Gnnz/s); "
        f"full fused op incl. topk {t_full.mean_ms:.4f} ms")

    # Training-step probe: one full SAGE 4x256 forward, backward and Adam
    # step on this graph at k = --k, one step a sample. Unit edge values
    # and a symmetric graph: the trainer normalises per its aggregation.
    n = csr.n_nodes
    ds = Dataset(
        name="bench", csr=csr.with_values(np.ones(csr.n_edges, np.float32)),
        features=x_np, labels=rng.integers(0, 41, size=n),
        train_mask=rng.uniform(size=n) < 0.66,
        val_mask=rng.uniform(size=n) < 0.1,
        test_mask=rng.uniform(size=n) < 0.2,
        num_classes=41, multilabel=False, metric="micro_f1",
        symmetric=True)
    cfg = types.SimpleNamespace(
        model="sage", hidden_dim=256, hidden_layers=4, maxk=args.k,
        dropout=0.5, norm=True, nonlinear="maxk", w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=97,
        # The CPU smoke run keeps f32; the card runs the production bf16.
        compute_dtype="float32" if dev.type == "cpu" else "bfloat16",
        device=str(dev))
    tr = Trainer(cfg, ds)
    tr.train_step()
    t_step = time_fn(tr.train_step, warmup=2, runs=3, calls=1)
    log(f"SAGE 4x256 k={args.k} train step: {t_step.mean_ms:.2f} ms")

    print(json.dumps({
        "metric": f"maxk_spgemm_fwd_nnz_per_s_k{args.k}_d{args.dim}",
        "value": round(t_fused.nnz_per_s(nnz) / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(t_base.mean_ms / t_fused.mean_ms, 4),
        "train_step_ms": round(t_step.mean_ms, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
