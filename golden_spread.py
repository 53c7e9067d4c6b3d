#!/usr/bin/env python
"""Golden accuracy over init seeds: the JAX reference, or the port.

  JAX_PLATFORMS=cpu python golden_spread.py --model gnn_res \\
      [--seeds 97-112] [--procs 4] [--dropout-offset N] \\
      [--nonlinear maxk|relu] [--k 32] [--metric micro_f1|rocauc] \\
      [--engine jax | torch [--device cpu|cuda] | torch-jax-init]
  JAX_PLATFORMS=cpu python golden_spread.py --model gnn_res --lockstep 103

Runs the golden synthetic recipe (``tools/golden_accuracy.py``'s ``Cfg``:
3x64, dropout 0.2, norm, float32, Adam 0.01, eval every 5, patience 10,
on ``GOLDEN_DATASET``) with MaxK k=32 once per init seed,
``--procs`` seeds at a time in separate processes. ``--nonlinear``, ``--k``
and ``--metric`` choose another row of the recipe: relu, another k, or the
multilabel dataset (``MULTILABEL_DATASET`` of
``maxk_tpu_torch/tools/golden_accuracy.py``) scored by micro-F1 or rocauc:

- ``jax``: ``maxk_tpu.train.loop.Trainer`` on the CPU;
- ``torch``: the port's run that the card's golden tests make
  (``golden_run``; the worker imports no JAX);
- ``torch-jax-init``: the port on the CPU from the reference's init of
  the same seed (its params and ``batch_stats``, by ``load_flax_params``),
  with the port's own dropout bits.

``--dropout-offset N`` draws the dropout bits from seed + N + 1 instead of
seed + 1 and keeps the init. Prints one JSON line per seed, then one with
the mean, median, standard deviation, minimum and maximum of best_test and
the count below ``GOLDEN_TAIL``. ``GOLDEN_DATASET``, ``golden_run`` and
``GOLDEN_TAIL`` are ``maxk_tpu_torch/tools/golden_accuracy.py``'s.

``--lockstep SEED`` runs both packages from the reference's init of SEED
at dropout 0 (so neither draws bits), 150 epochs with no early stop, and
prints every 5th epoch: each package's loss and val/test accuracy, the
port's val accuracy with BatchNorm on the batch's statistics instead of
the running ones, the largest difference of the two packages' running
mean and (relative) variance, and each package's largest |gconv_bias_i|.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent


def _jax_env():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [str(REPO), str(REPO / "tools")]
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def _jax_trainer(model: str, init_seed: int, path: str,
                 nonlinear: str = "maxk", k: int = 32, metric=None, **cfg):
    """The reference's golden Trainer for the row (model, nonlinear, k,
    metric) and its init state for `init_seed`."""
    _jax_env()
    from maxk_tpu_torch.tools.golden_accuracy import GOLDEN_DATASET
    from golden_accuracy import Cfg
    from maxk_tpu.data.datasets import (make_synthetic_dataset,
                                        make_synthetic_multilabel_dataset)
    from maxk_tpu.train.loop import Trainer
    from maxk_tpu_torch.tools.golden_accuracy import MULTILABEL_DATASET
    ds = (make_synthetic_dataset(**GOLDEN_DATASET) if metric is None else
          make_synthetic_multilabel_dataset(**MULTILABEL_DATASET,
                                            metric=metric))
    trainer = Trainer(Cfg(model=model, nonlinear=nonlinear, maxk=k or 32,
                          path=path, **cfg), ds)
    return trainer, trainer.init_state(seed=init_seed)


def _load_jax_init(port_model, state) -> None:
    import jax
    import numpy as np
    port_model.load_flax_params(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)
        if state.batch_stats else None)


def run_jax(model: str, seed: int, offset: int, row: dict) -> dict:
    """One golden run of the JAX reference, in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        # The fit draws its dropout bits from cfg.seed + 1.
        trainer, state = _jax_trainer(model, seed, tmp, **row,
                                      seed=seed + offset)
        res = trainer.fit(state=state)
    return dict(model=model, seed=seed, best_val=res.best_val,
                best_test=res.best_test, best_epoch=res.best_epoch,
                epochs_run=res.epochs_run)


def run_torch(model: str, seed: int, device: str, threads: int,
              offset: int, jax_init: bool, row: dict) -> dict:
    """One golden run of the port, in this process."""
    sys.path[:0] = [str(REPO)]
    import torch
    torch.set_num_threads(threads)
    from maxk_tpu_torch.tools.golden_accuracy import golden_run

    def prepare(trainer):
        if jax_init:
            with tempfile.TemporaryDirectory() as tmp:
                _load_jax_init(trainer.model,
                               _jax_trainer(model, seed, tmp, **row)[1])
        trainer.generator.manual_seed(seed + offset + 1)

    return golden_run(model, seed, device, prepare, **row)


def _val_batch_stats(trainer) -> float:
    """The port's val accuracy with BatchNorm normalising by the batch's
    own statistics, as in training (dropout is 0), running buffers kept."""
    import torch
    from maxk_tpu_torch.train import metrics
    saved = {k: v.clone() for k, v in trainer.model.named_buffers()}
    with torch.no_grad():
        logits = trainer.model(trainer.graphs, trainer.features,
                               training=True)
    trainer.model.load_state_dict(saved, strict=False)
    ds = trainer.dataset
    return metrics.evaluate_logits(logits.float().numpy(), ds.labels,
                                   ds.val_mask, ds.metric)


def lockstep(model: str, seed: int) -> None:
    """Both packages from the reference's init at dropout 0, epoch by
    epoch."""
    jax = _jax_env()
    import numpy as np
    from maxk_tpu_torch.tools.golden_accuracy import GOLDEN_DATASET
    from golden_accuracy import Cfg
    from maxk_tpu_torch.data.datasets import make_synthetic_dataset
    from maxk_tpu_torch.train.loop import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        jt, state = _jax_trainer(model, seed, tmp, seed=seed, dropout=0.0)
        cfg = Cfg(model=model, nonlinear="maxk", maxk=32, path=tmp,
                  seed=seed, dropout=0.0)
        cfg.device = "cpu"
        pt = Trainer(cfg, make_synthetic_dataset(**GOLDEN_DATASET))
        _load_jax_init(pt.model, state)
        rng = jax.random.PRNGKey(seed + 1)
        for epoch in range(cfg.epochs):
            rng, sub = jax.random.split(rng)
            state, loss_j = jt._jit_step(state, sub)
            loss_p = pt.train_step()
            if epoch % 5 and epoch != cfg.epochs - 1:
                continue
            acc_j, acc_p = jt.evaluate_masks(state), pt.evaluate_masks()
            row = dict(epoch=epoch, loss=[float(loss_j), float(loss_p)],
                       val=[acc_j[1], acc_p[1]], test=[acc_j[2], acc_p[2]])
            if state.batch_stats:
                row["val_port_batch_stats"] = _val_batch_stats(pt)
            layers = range(cfg.hidden_layers)
            if state.batch_stats:
                mean_d, var_d = [], []
                for i in layers:
                    bs = state.batch_stats[f"norm_{i}"]
                    bn = getattr(pt.model, f"norm_{i}")
                    mean_d.append(float(np.abs(
                        np.asarray(bs["mean"]) - bn.running_mean.numpy()
                    ).max()))
                    var_j = np.asarray(bs["var"])
                    var_d.append(float(np.abs(
                        var_j - bn.running_var.numpy()).max()
                        / np.abs(var_j).max()))
                row.update(bn_mean_diff=mean_d, bn_var_rel_diff=var_d)
            if "gconv_bias_0" in state.params:
                row["gconv_bias_absmax"] = [
                    [float(np.abs(np.asarray(
                        state.params[f"gconv_bias_{i}"])).max()) for i in layers],
                    [float(getattr(pt.model, f"gconv_bias_{i}").detach()
                           .abs().max()) for i in layers]]
            print(json.dumps(row), flush=True)


def _call(fn_args):
    fn, args = fn_args
    return fn(*args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gnn_res",
                    choices=["sage", "gcn", "gin", "gnn_res"])
    ap.add_argument("--seeds", default="97-112",
                    help="first-last init seeds, inclusive")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--engine", default="jax",
                    choices=["jax", "torch", "torch-jax-init"])
    ap.add_argument("--device", default="cpu",
                    help="the port's device (--engine torch)")
    ap.add_argument("--dropout-offset", type=int, default=0)
    ap.add_argument("--nonlinear", default="maxk", choices=["maxk", "relu"])
    ap.add_argument("--k", type=int, default=32, help="MaxK's k (maxk)")
    ap.add_argument("--metric", default=None, choices=["micro_f1", "rocauc"],
                    help="the multilabel dataset, scored by this metric")
    ap.add_argument("--lockstep", type=int, metavar="SEED")
    args = ap.parse_args()
    if args.lockstep is not None:
        lockstep(args.model, args.lockstep)
        return 0
    first, last = (int(s) for s in args.seeds.split("-"))
    seeds = range(first, last + 1)
    row = dict(nonlinear=args.nonlinear,
               k=args.k if args.nonlinear == "maxk" else 0,
               metric=args.metric)
    if args.engine == "jax":
        fn, jobs = run_jax, [(args.model, s, args.dropout_offset, row)
                             for s in seeds]
    else:
        threads = max(1, (os.cpu_count() or 1) // args.procs)
        device = args.device if args.engine == "torch" else "cpu"
        fn, jobs = run_torch, [(args.model, s, device, threads,
                                args.dropout_offset,
                                args.engine == "torch-jax-init", row)
                               for s in seeds]
    sys.path[:0] = [str(REPO)]
    from maxk_tpu_torch.tools.golden_accuracy import GOLDEN_TAIL
    runs = []
    with multiprocessing.get_context("spawn").Pool(args.procs) as pool:
        for run in pool.imap(_call, [(fn, job) for job in jobs]):
            print(json.dumps(run), flush=True)
            runs.append(run)
    tests = [r["best_test"] for r in runs]
    print(json.dumps(dict(
        model=args.model, **row, engine=args.engine, seeds=args.seeds,
        dropout_offset=args.dropout_offset,
        device=args.device if args.engine == "torch" else "cpu",
        mean_best_test=statistics.mean(tests),
        median_best_test=statistics.median(tests),
        std_best_test=statistics.stdev(tests) if len(tests) > 1 else 0.0,
        min_best_test=min(tests), max_best_test=max(tests),
        n_below_tail=sum(t < GOLDEN_TAIL for t in tests))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
