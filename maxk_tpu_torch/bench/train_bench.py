"""Full-graph train-step benchmark — the port's counterpart of
``train_bench.py`` (the BASELINE.md "reddit epoch time" north star), on
one CUDA card by default.

  python -m maxk_tpu_torch.bench.train_bench        # reddit-shaped synthetic
  python -m maxk_tpu_torch.bench.train_bench --dataset reddit --data_path ./data/
  python -m maxk_tpu_torch.bench.train_bench --n-nodes 100000 --avg-degree 50
  python -m maxk_tpu_torch.bench.train_bench --device cpu --n-nodes 300 \\
      --avg-degree 4 --epochs 2 --compute_dtype float32

Builds a reddit-shaped synthetic graph by default (V = 232,965, one-way
degree 246, symmetrized; 602 features, 41 classes: the real dataset's
shape), drawn exactly as the JAX script draws it, or loads a preprocessed
``.npz`` with ``--dataset``. Then it times ``Trainer.train_step`` (SAGE
4x256, MaxK k = 32, bf16 by default; dropout 0.5, norm, Adam 0.01, seed
97) and the full-graph evaluation forward ``Trainer.eval_logits``.
``--compute_dtype int8`` runs the aggregations on the quantized gather
(K7), as the JAX script's flag, which has no choices, allows.

Timing: one first step (its loss is the ``loss`` reported, as the JAX
script reports its compile call's), 2 warm-up steps, then ``max(2,
--epochs)`` steps, each between two CUDA events (the host clock on the
CPU); ``train_step_ms`` is their mean. The evaluation forward: a first
call, 2 warm-up calls, 4 timed. One difference from the JAX script: it
times the same state again and again, while here each step updates the
parameters, as a real step does.

Prints one JSON line on stdout with the JAX script's keys (``metric``,
``graph``, ``n_nodes``, ``n_edges``, ``model``, ``nonlinear``, ``k``,
``hidden``, ``layers``, ``train_step_ms``, ``eval_forward_ms``,
``loss``), and the timed steps' median, minimum and maximum, each step,
the peak device memory, the host seconds of the graph build and of the
trainer's build, each kernel's launches a timed step, and the device (on
CUDA the card's name and power limit as ``nvidia-smi`` gives them). The
``#`` lines go to stderr.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import types

import numpy as np
import torch

# The JAX script's keys, in its order (train_bench.py's output line).
JAX_KEYS = ("metric", "graph", "n_nodes", "n_edges", "model", "nonlinear",
            "k", "hidden", "layers", "train_step_ms", "eval_forward_ms",
            "loss")
WARMUP = 2
EVAL_RUNS = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None,
                    help="real dataset name (needs .npz under --data_path)")
    ap.add_argument("--data_path", default="./data/")
    ap.add_argument("--model", default="sage")
    ap.add_argument("--hidden_dim", type=int, default=256)
    ap.add_argument("--hidden_layers", type=int, default=4)
    ap.add_argument("--maxk", type=int, default=32)
    ap.add_argument("--nonlinear", default="maxk", choices=["maxk", "relu"])
    ap.add_argument("--n-nodes", type=int, default=232965)
    ap.add_argument("--avg-degree", type=float, default=246.0,
                    help="one-direction degree; symmetrization doubles it")
    ap.add_argument("--in-size", type=int, default=602)
    ap.add_argument("--n-classes", type=int, default=41)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu for a smoke run)")
    return ap.parse_args(argv)


def reddit_dataset(n_nodes: int = 232965, avg_degree: float = 246.0,
                   in_size: int = 602, n_classes: int = 41):
    """The JAX script's synthetic dataset, draw for draw: the seed-123
    power-law graph, symmetrized, then features, labels and the train,
    val and test masks from one seed-123 stream."""
    from maxk_tpu_torch.data.datasets import Dataset
    from maxk_tpu_torch.data.loaders import synthetic_graph
    rng = np.random.default_rng(123)
    csr = synthetic_graph(n_nodes, avg_degree, seed=123, power_law=True,
                          symmetric=True)
    v = csr.n_nodes
    return Dataset(
        name="synthetic-reddit", csr=csr,
        features=rng.normal(size=(v, in_size)).astype(np.float32),
        labels=rng.integers(0, n_classes, size=v),
        train_mask=rng.uniform(size=v) < 0.66,
        val_mask=rng.uniform(size=v) < 0.1,
        test_mask=rng.uniform(size=v) < 0.2,
        num_classes=n_classes, multilabel=False, metric="micro_f1",
        symmetric=True)


def bench_config(args) -> types.SimpleNamespace:
    """The JAX script's training config, plus the device."""
    return types.SimpleNamespace(
        model=args.model, hidden_dim=args.hidden_dim,
        hidden_layers=args.hidden_layers, maxk=args.maxk, dropout=0.5,
        norm=True, nonlinear=args.nonlinear, w_lr=0.01, w_weight_decay=0.0,
        enable_lookahead=False, seed=97, compute_dtype=args.compute_dtype,
        device=args.device)


def main(argv=None) -> int:
    args = parse_args(argv)

    from maxk_tpu_torch.data.datasets import load_dataset
    from maxk_tpu_torch.ops.graph import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.dataset:
        ds = load_dataset(args.dataset, args.data_path)
    else:
        ds = reddit_dataset(args.n_nodes, args.avg_degree, args.in_size,
                            args.n_classes)
    graph_s = time.perf_counter() - t0
    print(f"# {ds.name}: V={ds.csr.n_nodes} E={ds.csr.n_edges} "
          f"F={ds.in_size} device={dev} ({graph_s:.1f}s)", file=sys.stderr)
    print(json.dumps(measure(args, ds, dev, graph_s)))
    return 0


def measure(args, ds, dev, graph_s: float = 0.0, graphs=None) -> dict:
    """The timed run on a built dataset: a Trainer of ``bench_config(args)``
    (on ``graphs`` if given, else built), its first step, warm-up and
    timed steps and evaluations; returns the output line's dict."""
    from maxk_tpu_torch.bench.harness import device_info
    from maxk_tpu_torch.ops import kernel_counters
    from maxk_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    tr = Trainer(bench_config(args), ds, graphs=graphs, device=dev)
    trainer_s = time.perf_counter() - t0
    print(f"# graph build + device put: {trainer_s:.1f}s", file=sys.stderr)

    def timed(fn, n: int) -> list:
        """ms of each of n calls: CUDA events around each on a CUDA
        device, the host clock on the CPU (Trainer._timed)."""
        return [tr._timed(fn)[1] * 1e3 for _ in range(n)]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loss = float(tr.train_step())
    timed(tr.train_step, WARMUP)
    counted = kernel_counters()
    for fn in counted.values():
        fn.launches = 0
    steps = timed(tr.train_step, max(2, args.epochs))
    launches = {name: fn.launches / len(steps)
                for name, fn in counted.items()}

    tr.eval_logits()
    timed(tr.eval_logits, WARMUP)
    evals = timed(tr.eval_logits, EVAL_RUNS)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)

    return dict(metric="train_step_ms", graph=ds.name,
                n_nodes=ds.csr.n_nodes, n_edges=ds.csr.n_edges,
                model=args.model, nonlinear=args.nonlinear, k=args.maxk,
                hidden=args.hidden_dim, layers=args.hidden_layers,
                train_step_ms=statistics.mean(steps),
                eval_forward_ms=statistics.mean(evals), loss=loss,
                compute_dtype=args.compute_dtype,
                train_step_median_ms=statistics.median(steps),
                train_step_min_ms=min(steps), train_step_max_ms=max(steps),
                train_steps_ms=steps, eval_forward_runs_ms=evals,
                peak_mem_gib=peak, graph_build_s=graph_s,
                trainer_build_s=trainer_s, launches_per_step=launches,
                device=device_info(dev))


if __name__ == "__main__":
    sys.exit(main())
